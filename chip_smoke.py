"""Smoke run of the PyTorch port (``mvdetr_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code:

1. card name and power limit, torch and CUDA versions; build the four CUDA
   kernels from ``mvdetr_tpu_torch/csrc`` (one ``nvcc`` each, all started
   together; timed) and print each build log; build the data path's host
   library (``mvdetr_tpu_torch/native/dataio.cpp``, g++);
2. B1, the windowed deformable-attention forward, against its plain PyTorch
   version on the card, two launches bitwise equal: at the flagship shape
   (random offsets past the clamp, and integer offsets; both timed), at
   narrow shapes (M*D=32 at R=0, 1, 8, 12 and 16; a 37x101 grid; D=8, 32
   and 5; 5 cameras over 3 levels), and, timed, at the flagship shape at
   R=16 (R=12 and 16 close B4, the TPU's large-radius variant);
   B1 and B2 also at the shape the CLI recipe and the convergence rigs
   launch them at (B=1, L=C=4, 15x30, random and integer offsets), after
   B2's cases;
3. B2, its backward, against the plain backward: at the flagship shape
   (random offsets past the clamp; the radial init shifted by integers, where
   exactly integer offsets must get exactly zero cotangents), both timed
   whole and by side (value side, query side, each beside its bound), at
   narrow shapes (R=0, 1, 8, 12 and 16; a 37x101 grid; D=8, 32 and 5;
   5 cameras over 3 levels), and at the flagship shape at R=16 (query side
   timed); two launches must be bitwise equal; each case prints the query
   side's plan;
3b. B1 and B2 in ``row_halo`` mode (``row_halo_phase``), the BEV-row
   sharded path's kernels, at the flagship shape: zero halo rows must give
   the zero-padded kernels' bits; over 2, 4 and 6 shards each shard against
   the plain ``row_halo`` versions with a bitwise repeat, the composed
   shards' output, g_offsets and g_weights bitwise the unsharded kernels',
   g_value bitwise on the rows one shard's queries alone reach and within
   ROW_HALO_ATOL where two halos add (summed as the halo exchange sums it),
   one shard of each timed beside its bound; then the counted run,
   ``compose_bev_shards`` over 2 shards through autograd (B1 and B2 once a
   shard, in halo mode);
3c. camera sharding's kernels (``view_phase``), the view ranks composed in
   one process at the flagship's width: 7 cameras over 7 ranks and a
   6-camera rig over 2 and 3; B1 on each rank's query blocks over all the
   levels bitwise the unsharded kernel's blocks, B2's g_offsets and
   g_weights bitwise, its g_value summed over the ranks in rank order within
   VIEW_GV_ATOL; B3 on each rank's cameras bitwise the unsharded camera
   slices; one rank of each timed beside its bound; then the counted run,
   path ``composed_view_shards``: the 7 ranks' attention and warp through
   autograd, B1, B2 and B3 once a rank;
4. B3, the warp backward, against its plain version at the flagship shape
   (g [14, 43200, 128] bf16 at the coordinates of the bench rig's homographies
   with non-identity augmentation affines; its segment statistics printed),
   a narrow f32 shape and the stress cases of ``warp_stress_cases`` (one
   cell of thousands of entries, segments around the walk's batches, every
   tap outside, NaN and +-1e6 coordinates, C=5 and 40 in f32 and 300 in
   bf16, a sort whose sentinel takes its top bit, a misaligned g), and in
   f32 at the coordinates of the CLI recipe's and the convergence rigs'
   homographies (g [4, 1800, 128] -> 15x27); bitwise repeat; ``grad_input`` of ``aten.grid_sampler_2d_backward`` timed beside
   it; kernels and plain versions timed with CUDA events;
4b. the 8-point shadow path's kernel shapes: B1 and B2 over the 56
   pseudo-levels of one point of the bench rig's shadow stack (B=2, C=7,
   60x180, M=8, D=16, R=4; random offsets past the clamp, and the radial
   init of 7 cameras x 8 points shifted by integers; each timed, B2 also by
   side; untimed at B=1 and B=4) and over the recipe's 32 (B=1, C=4,
   15x30); B3 at the bench rig's 8-point shadow coordinates (g [14, 86400,
   128] -> 60x180) in bf16, timed,
   with its segment statistics, device time by stage and the library call,
   and in f32, and at the recipe rig's in f32; every case against its plain
   version with a bitwise repeat;
4c. gather attention (``ops/msda.py``, the ``--attn_mode gather`` and
   ``--world_feat aio`` encoders): the card against the CPU in f32 (output
   and the offsets' and weights' gradients at the flagship's shape, B=2,
   L=C=7, 60x180, M=8, D=16, P=4, and at aio's, one level of 120x360; all
   three gradients at the recipe's, B=1, L=4, 15x30), and against B1/B2
   (the windowed = gather identity where no clamp binds: offsets inside
   +-3, away from integers) at the recipe's and the flagship's shapes; one
   layer's forward and forward + backward timed in bf16; B3 at the
   coordinates of gather's value gradient (g [112, 302400, 16] at the
   radial init in bf16, timed, with its segments, its device time by stage
   and the library call; at random offsets in f32) and of aio's (g [16,
   172800, 16]), against its plain version with a bitwise repeat;
4d. B3 at the coordinates of deform_conv's input gradient (a seeded
   ``DeformConvWorldFeat``'s offsets on a random 7-camera 120x360 stack,
   g [14, 388800, 128] f32) against its plain version with a bitwise
   repeat, timed, with its segments, its device time by stage and the
   library call; the module's forward and forward + backward timed, the
   backward launching B3 once;
5. B5, the lane broadcast / reduce experiment: each of its six variants
   against its plain version at T=1104 and T=151,200 rows (within 1e-5 of
   the largest output), the variants against each other (``repeat`` tiles,
   so it must differ from the three broadcasts), the plain versions timed;
   then the experiment's entry point
   (``mvdetr_tpu_torch.scripts.exp_vpu_broadcast.main``) as the counted run,
   which times every variant at 81 repetitions and at 1, at both sizes;
6. a small model on the card against the same weights on the CPU, in f32:
   the inference forward, then one train step (loss, gradients, updated
   parameters and BatchNorm statistics); then each of ``conv``, ``trans``,
   ``deform_conv``, ``vgg11`` and ``remat`` likewise (``SMALL_VARIANT_RTOL``),
   and a card step with remat bitwise equal to the same step without;
7. serving at Wildtrack width: 7 cameras, 720x1280 uint8 frames (1080x1920
   rig frames at img_reduce=12), 120x360 BEV, 60x180 encoder grid, shadow
   transformer at n_points=4 and radius 4, bf16 compute, batch 2; one
   warm-up and three timed requests through ``eval_step``, which must launch
   B1 3 times each; a profile of one request;
8. training at the same width (the configuration ``bench.py`` times: 20
   people per frame set, top-100 targets, lr 5e-4 over 100 steps, encoder
   dropout 0.1): one warm-up and five timed ``train_step`` calls on one
   device-resident batch, each launching B1 3 times, B2 3 times and B3 once,
   with a finite loss; a profile of one step; then whether two steps from the
   same state and generator give bitwise-equal parameters and gradients
   with PyTorch's default algorithms (required), and with
   ``torch.use_deterministic_algorithms`` (reported, with both step times);
8b. serving (1 + 3 requests: B1 3 times each, B2 and B3 none) and training
   (1 + 5 steps: B1 and B2 3 times each, B3 4 times: the camera warp and
   each encoder layer's shadow warp) of the ``n_points=8`` model at the same
   width, bf16, batch 2 (warped attention), with profiles of a request and a
   step and the bitwise repeat of two steps (required);
8c. serving (1 + 3 requests, no kernel launch) and training (1 + 5 steps:
   B3 4 times each, the camera warp's and each encoder layer's value
   gradient; B1 and B2 none) with ``--attn_mode gather`` at the same width,
   then the ``aio`` model (1 + 1 requests, 1 + 3 steps, the same launches);
   each with profiles of a request and a step and the bitwise repeat of two
   steps (required);
8d. serving (1 + 2 requests) and training (1 + 3 steps, bitwise repeat)
   of ``conv``, ``trans``, ``deform_conv``, ``vgg11`` and ``remat`` at the
   same width, bf16: B1/B2/B3 per step 0/0/1, 0/0/1, 0/0/2, 3/3/1, 3/3/1,
   per request none or (windowed) 3/0/0; medians and peaks summarised
   after the CLI phases;
8e. the data-parallel step on a one-rank NCCL group (``nccl_phase``;
   ``torch.distributed`` over ``tcp://localhost``, the mesh's groups all of
   this rank): the flagship at full width, state broadcast, 1 + 3 sharded
   steps (gradient, BatchNorm and loss-normaliser all-reduces and the
   replication check through NCCL; B1/B2/B3 3/3/1 a step, counted) bitwise
   equal to as many plain steps, one sharded eval step's detections equal
   to the plain one's, and ``Trainer`` with the mesh and without it over
   one epoch and a test of the recipe's scene giving the same loss and
   MODA; a second GPU, and with it the exchange between ranks, is not
   there;
8f. the ``--visualize`` captures (``visualize_phase``): at a small size the
   card against the CPU in windowed, warped and gather mode (every layer's
   sampling locations and weights, the forward stages); at full width both
   captures counted (B1 3 times each); the CLI recipe for one epoch with
   ``--visualize`` (the figures written, or the line saying they were
   skipped without matplotlib);
9. B3's device time at the flagship by stage and by device activity, from
   torch.profiler after the serve and train profiles: all but one memset of
   its sort must be kernels named ``warp_bwd``, and B3's share of the step
   is those kernels in the step profile plus that memset;
10. the CLI and the ``Trainer`` (``mvdetr_tpu_torch.cli``), with every
    kernel counted on each run (B1/B2/B3 3/3/1 per train step, 3 B1 per
    eval batch, no B5) and the steps, data stages and epochs instrumented
    (``EpochProbe``):
    (a) the synthetic recipe of the repo's verify notes (``SKILL.md``) through ``cli.main``
    (10 epochs of the synthetic scene, ``--deterministic true``): the
    determinism check must pass and the last epoch's MODA reach 80; then the
    same recipe with ``--n_points 8`` (warped attention, B3 4 times per
    train step), under the same gates;
    (b) ``tests/test_convergence.py``'s contract through ``Trainer`` on its xy
    and ij rigs: MODA >= 85, precision >= 90, the last epoch's loss below
    half the first;
    (c) two epochs at Wildtrack width through ``cli.main`` (7 cameras,
    1080x1920 frames, 480x1440 grid, bf16, batch 2, 4 loader threads): per
    epoch the train and test frame-sets/s and the card's busy share, both
    also after the fill (from the first step on), peak memory and the
    host's thread time per frame set by data stage (epoch 1 renders the
    scene, epoch 2 reads the cache);
    (d) the reference-checkpoint path (``--load_torch_ckpt``) through
    ``cli.main`` at the recipe's size, on a ``MultiviewDetector.pth`` built
    from a seeded port model with its offset biases scaled to reach 9.6
    cells: gather mode evaluates with no kernel launch; the defaults pick
    radius 11 and launch B1 3 times per eval batch with no clamp binding; a
    wrong ``--n_points`` exits with the flag to pass; both print a MODA
    line, and their BEV heatmaps agree (on the CPU within 1e-4 of scale);
    (e) each variant's flag through ``cli.main``: 2 epochs of the recipe
    with ``--deterministic true``, its launches counted, MODA printed;
    (k) the hard accuracy benchmark through its twin's ``run()``
    (``mvdetr_tpu_torch/scripts/hard_benchmark.py``: seed 5, 15 epochs,
    windowed, 4 points): FINAL MODA, MODP, precision, recall and wall time
    printed, MODA >= 85 (the JAX package's worst-seed panel floor);
    (l) the disk path at full width: a Wildtrack-format tree of 12 frames
    of 1080x1920 PNGs (``data/trees.py``) in a temporary directory, every
    frame decoded by ``data/png.py`` bitwise equal to the scene's render,
    then one epoch of ``cli.main(["-d", "wildtrack", "--data_root", tree,
    "--bf16", "true", "-b", "2", "-j", "4", ...])``: train and test
    frame-sets/s, busy share and the decode's thread-ms per frame;
    (m) the day-one rehearsal on that tree
    (``mvdetr_tpu_torch/scripts/rehearse_day_one.py``): a seeded port model
    at the flagship configuration saved as a reference
    ``MultiviewDetector.pth`` and evaluated through ``--load_torch_ckpt``
    in windowed mode at R=8, batch 1: B1 3 times per eval batch, no clamp
    binding, the MODA line printed;
11. one JSON line with each kernel's launches (by path: serve, train, cli,
    trainer, experiment, shadow: the n_points-8 serve, train and recipe
    runs, gather and aio: their serve and train runs, checkpoint: the
    checkpoint evaluations; each variant's serve, train and cli runs;
    hard_benchmark, disk and day_one: phases (k), (l) and (m); nccl: the
    one-rank NCCL steps; composed_view_shards: the one-process
    composition of 7 view ranks; visualize: the full-width captures), one
    view rank's times by cameras and ranks (``view_rank``), B1 and B2's
    ``row_halo`` launches as rows of
    their own (``<name>:row_halo``: one shard of 2 at the flagship shape,
    4 and 6 shards under ``by_shards``, launches from the counted
    one-process composition, path ``composed_bev_shards``),
    error, times and bound, B1/B2/B3's times at the shadow shapes
    (``*_shadow``), B3's at gather's (``*_gather``, aio's under
    ``aio_gather``) and deform_conv's (``*_deform_conv``), and the gather
    layer's times.

The line before the last is the card's ``name, power.limit`` as nvidia-smi
reports them; the last line is ``{"ok": true, "device": {...}}``. Imports
nothing of JAX. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import copy
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOP_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
KERNEL_ATOL = 5e-5  # B1: f32 sums of L*P=28 samples in another order; outputs |x| < ~5
BWD_ATOL = 1e-4  # B2: f32 sums of up to a few hundred terms in another order, of scale max(1, max|ref|)
WARP_RTOL = 2.0**-6  # B3 in bf16: the final rounding may land one bf16 step (2^-8..2^-7 of the value) apart
SMALL_MODEL_RTOL = 2e-2  # card stages the attention value in bf16 (2^-9 relative), the CPU keeps f32
BWD_FLOP_PER_SAMPLE_CHANNEL = 30  # B2: ~3x B1's 10 (three cotangent sums, four value taps)
BWD_VALUE_FLOP_PER_SAMPLE_CHANNEL = 8  # B2's value side: four taps, one FMA each (the query side the other 22)
LANE_RTOL = 1e-5  # B5, of max|ref|: 81 f32 sums that differ only by FMA contraction, the shuffle tree, the tf32 split
# B2's g_value where two BEV shards' halo gradients add (of max(1, max|ref|)): one f32 partial sum split in two, each
# of ~100 terms of order 0.01 at the flagship shape, so a few f32 ulps of the sum
ROW_HALO_ATOL = 1e-5
ROW_HALO_SHARDS = (2, 4, 6)  # BEV shards of the flagship's 60 encoder rows: 30, 15 and 10 rows, each >= R = 4
ROW_HALO_ATTENTION = dict(b=2, l=7, h=60, w=180, m=8, d=16, p=4, r=4)  # the flagship's attention (C = L cameras)
# camera sharding: (cameras, view shards) at the flagship's width; 7 cameras divide only over 7 view ranks
VIEW_CASES = ((7, 7), (6, 2), (6, 3))
# B2's g_value summed over the view ranks in rank order against the unsharded kernel's (of max(1, max|ref|)): each
# value tap's gradient sums the samples of every query block that reaches it, ~C*P*M terms of order 0.01 at the
# flagship shape, regrouped into V partial sums: a few f32 ulps of the sum
VIEW_GV_ATOL = 1e-5
LR, TOTAL_STEPS = 5e-4, 100
# medians measured on an H100 80GB HBM3 at 700 W while the BEV upsample was F.interpolate (PERF.md)
INTERP_SERVE_MS, INTERP_TRAIN_MS = 62.37, 246.25


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, reps: int) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after one warm-up."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(nbytes: float, flops: float) -> dict:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3, "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def perturb_attention(model, seed: int, scale: float = 0.05) -> None:
    """Random weights for the zero-initialised offset and attention-weight
    projections, so offsets vary per query and some bind the clamp."""
    import torch

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("sampling_offsets.weight", "attention_weights.weight")):
                p.copy_(torch.randn(p.shape, generator=g) * scale)


def bench_rig(num_cam=7):
    """The rig of bench.py: 1080x1920 frames (720x1280 input at img_reduce=12),
    a 480x1440 grid (120x360 BEV at world_reduce=4, 60x180 encoder grid);
    ``num_cam`` cameras (7 as Wildtrack's)."""
    from mvdetr_tpu_torch.geometry import make_synthetic_rig

    return make_synthetic_rig(
        num_cam=num_cam, img_shape=(1080, 1920), worldgrid_shape=(480, 1440),
        cell_meters=0.025, indexing="ij", worldcoord_unit=0.01, origin_offset=(-300.0, -900.0),
        camera_height_m=6.0, camera_margin_m=4.0, name="BenchWildtrack",
    )


def train_batch(rig, batch_size, world_reduce, img_reduce, seed, num_person=20, top_k=100, augment=True):
    """A training batch built with the port's ``build_targets``: random uint8
    frames; ``num_person`` people at random cells of the full-resolution BEV
    grid, projected into each camera through the rig's ground-plane (feet) and
    1.8 m (heads) homographies and the frame's augmentation affine (random
    scale, shear and shift when ``augment``, else identity)."""
    from mvdetr_tpu_torch.data import build_targets

    rng = np.random.default_rng(seed)
    n = rig.num_cam
    img_h, img_w = rig.img_shape
    gh, gw = rig.worldgrid_shape
    r_img = (-(-img_h // img_reduce), -(-img_w // img_reduce))
    feet, heads = rig.img_from_world(0.0), rig.img_from_world(1.8)

    def project(mat, pts):
        hom = np.concatenate([pts, np.ones((len(pts), 1))], 1) @ mat.T
        z = hom[:, 2:]
        return np.where(z > 1e-6, hom[:, :2] / np.where(z > 1e-6, z, 1.0), -1e6)

    imgs = rng.integers(0, 256, (batch_size, n, img_h * 8 // img_reduce, img_w * 8 // img_reduce, 3), np.uint8)
    affs, world_gt, imgs_gt = [], [], []
    for _ in range(batch_size):
        pts = rng.uniform((0.0, 0.0), (gw, gh), (num_person, 2))
        pids = np.arange(num_person)
        world_gt.append(build_targets((gh // world_reduce, gw // world_reduce), pts[:, 0], pts[:, 1], pids=pids,
                                      reduce=world_reduce, top_k=top_k, kernel_size=10.0))
        cams, cam_gt = [], []
        for cam in range(n):
            aff = np.eye(3)
            if augment:
                aff[:2, :2] += rng.uniform(-0.08, 0.08, (2, 2))
                aff[:2, 2] = rng.uniform(-0.03, 0.03, 2) * (img_w, img_h)
            foot, head = project(aff @ feet[cam], pts), project(aff @ heads[cam], pts)
            hgt = np.abs(foot[:, 1] - head[:, 1])
            cam_gt.append(build_targets(r_img, foot[:, 0], foot[:, 1], hgt / 2.5, hgt, pids, reduce=img_reduce,
                                        top_k=top_k, kernel_size=10.0))
            cams.append(aff.astype(np.float32))
        affs.append(np.stack(cams))
        imgs_gt.append({k: np.stack([g[k] for g in cam_gt]) for k in cam_gt[0]})
    return {"imgs": imgs, "affine_mats": np.stack(affs),
            "world_gt": {k: np.stack([g[k] for g in world_gt]) for k in world_gt[0]},
            "imgs_gt": {k: np.stack([g[k] for g in imgs_gt]) for k in imgs_gt[0]}}


def attention_inputs(rng, b, l, h, w, m, d, p, radius, integer, c=None, init=None):
    """bf16 value, f32 offsets (uniform past the clamp, or the radial init
    shifted by integers) and softmax weights, on the card; ``c`` cameras
    (default ``l``). ``init``: the (levels, points) the radial init is drawn
    for, laid out as the ``l`` levels of ``p`` points (default ``(l, p)``;
    the shadow stack's 56 pseudo-levels of one point take 7 cameras' 8)."""
    import torch

    from mvdetr_tpu_torch.models.deformable import radial_offset_bias

    c = l if c is None else c
    value = torch.from_numpy(rng.standard_normal((b, l, h, w, m, d), dtype=np.float32))
    if integer:
        off = radial_offset_bias(m, *(init or (l, p)), max_radius=radius).reshape(m, l, p, 2) + rng.integers(
            -2, 3, (b, c, h, w, m, l, p, 2))
    else:
        off = rng.uniform(-radius - 2.0, radius + 2.0, (b, c, h, w, m, l, p, 2))
    logits = torch.from_numpy(rng.standard_normal((b, c, h, w, m, l * p), dtype=np.float32))
    wgt = torch.softmax(logits, -1).reshape(b, c, h, w, m, l, p)
    return value.cuda().to(torch.bfloat16), torch.from_numpy(off.astype(np.float32)).cuda(), wgt.cuda()


def fwd_case(name, b, l, h, w, m, d, p, radius, integer, rng, timed, c=None, init=None):
    """B1 vs its plain version on the card at one shape (``c`` cameras,
    default ``l``); two launches must be bitwise equal. Returns a record."""
    import torch

    from mvdetr_tpu_torch.ops.msda_windowed import _fwd_plan, _value_align, ms_deform_attn_windowed, msda_windowed_fwd

    c = l if c is None else c
    v, o, wg = attention_inputs(rng, b, l, h, w, m, d, p, radius, integer, c=c, init=init)
    out = msda_windowed_fwd(v, o, wg, radius)
    again = msda_windowed_fwd(v, o, wg, radius)
    ref = ms_deform_attn_windowed(v, o, wg, radius, flatten=False)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    plan = _fwd_plan(w, m, d, p, radius, value_align=_value_align(v))  # the plan the wrapper launched
    print(f"B1 {name}: B={b} L={l} C={c} {h}x{w} M={m} D={d} P={p} R={radius} max_abs_err={err:.3e} "
          f"(max |out| {float(ref.abs().max()):.3f}, clamp binds {float((o.abs() > radius).float().mean()):.3f}), "
          f"bitwise repeat; plan vec={plan.vec} tile {plan.tile_y}x{plan.tile_x}, {plan.threads} threads")
    check(bool(torch.isfinite(out).all()), f"B1 {name}: non-finite output")
    check(err <= KERNEL_ATOL, f"B1 {name}: max abs error {err} > {KERNEL_ATOL}")
    check(torch.equal(out, again), f"B1 {name}: two launches differ")
    rec = {"err": err}
    if timed:
        nbytes = v.numel() * 2 + o.numel() * 4 + wg.numel() * 4 + out.numel() * 4
        rec.update(bound(nbytes, 10 * out.numel() * l * p))  # 4 taps x (mul+add) + weight FMA
        rec["ms"] = cuda_ms(lambda: msda_windowed_fwd(v, o, wg, radius), 20)
        rec["plain_ms"] = cuda_ms(lambda: ms_deform_attn_windowed(v, o, wg, radius, flatten=False), 5)
        print(f"B1 {name}: kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.4f} "
              f"ms ({rec['bound_by']}, {nbytes / 1e6:.1f} MB)")
    return rec


def bwd_case(name, b, l, h, w, m, d, p, radius, integer, rng, timed, c=None, init=None):
    """B2 vs the plain backward on the card at one shape (``c`` cameras,
    default ``l``); when ``timed``, the whole launch, its value side and its
    query side are timed, each beside its bound (``timed="query"``: the
    query side alone). Returns a record."""
    import torch

    from mvdetr_tpu_torch.ops.msda_windowed import _query_plan, ms_deform_attn_windowed_bwd, msda_windowed_bwd

    c = l if c is None else c
    v, o, wg = attention_inputs(rng, b, l, h, w, m, d, p, radius, integer, c=c, init=init)
    g = torch.from_numpy(rng.standard_normal((b, c, h, w, m * d), dtype=np.float32)).cuda()
    out = msda_windowed_bwd(v, o, wg, g, radius)
    again = msda_windowed_bwd(v, o, wg, g, radius)
    ref = ms_deform_attn_windowed_bwd(v, o, wg, g, radius)
    torch.cuda.synchronize()
    errs = []
    for what, a, a2, r in zip(("g_value", "g_offsets", "g_weights"), out, again, ref):
        err, scale = float((a - r).abs().max()), float(r.abs().max())
        errs.append(err)
        check(bool(torch.isfinite(a).all()), f"B2 {name}: non-finite {what}")
        check(err <= BWD_ATOL * max(1.0, scale), f"B2 {name}: {what} max abs error {err} (scale {scale})")
        check(torch.equal(a, a2), f"B2 {name}: {what} differs between two launches")
    msg = ""
    if integer:
        exact = o == torch.round(o)
        nonzero = int((out[1][exact] != 0).sum())
        msg = f", {float(exact.float().mean()):.3f} of offsets exact integers, {nonzero} nonzero cotangents there"
        check(nonzero == 0, f"B2 {name}: integer offsets got nonzero cotangents")
    plan = _query_plan(v, g, p, radius)  # the plan the wrapper launched the query side with
    print(f"B2 {name}: B={b} L={l} C={c} {h}x{w} M={m} D={d} P={p} R={radius} max_abs_err g_value/g_offsets/g_weights "
          f"{errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e}, bitwise repeat{msg}; query side plan vec={plan.vec} tile "
          f"{plan.tile_y}x{plan.tile_x}, {plan.threads} threads")
    rec = {"err": max(errs)}
    if timed:
        value_flops = BWD_VALUE_FLOP_PER_SAMPLE_CHANNEL * wg.numel() * d
        query_bytes = v.numel() * 2 + (o.numel() + wg.numel() + g.numel() + out[1].numel() + out[2].numel()) * 4
        rec["query_bound_ms"] = bound(query_bytes, BWD_FLOP_PER_SAMPLE_CHANNEL * wg.numel() * d - value_flops)["bound_ms"]
        rec["query_ms"] = cuda_ms(lambda: msda_windowed_bwd(v, o, wg, g, radius, side="query"), 10)
        if timed == "query":
            print(f"B2 {name}: query side {rec['query_ms']:.4f} ms, bound {rec['query_bound_ms']:.4f} ms "
                  f"({query_bytes / 1e6:.1f} MB)")
            return rec
        nbytes = (v.numel() * 2 + (o.numel() + wg.numel() + g.numel()) * 4
                  + sum(x.numel() for x in out) * 4)
        value_bytes = (o.numel() + wg.numel() + g.numel() + out[0].numel()) * 4
        rec.update(bound(nbytes, BWD_FLOP_PER_SAMPLE_CHANNEL * wg.numel() * d))
        rec["value_bound_ms"] = bound(value_bytes, value_flops)["bound_ms"]
        rec["ms"] = cuda_ms(lambda: msda_windowed_bwd(v, o, wg, g, radius), 10)
        rec["value_ms"] = cuda_ms(lambda: msda_windowed_bwd(v, o, wg, g, radius, side="value"), 10)
        rec["plain_ms"] = cuda_ms(lambda: ms_deform_attn_windowed_bwd(v, o, wg, g, radius), 3)
        print(f"B2 {name}: kernel {rec['ms']:.4f} ms (value side {rec['value_ms']:.4f} ms, bound "
              f"{rec['value_bound_ms']:.4f} ms, {value_bytes / 1e6:.1f} MB; query side {rec['query_ms']:.4f} ms, "
              f"bound {rec['query_bound_ms']:.4f} ms, {query_bytes / 1e6:.1f} MB), plain {rec['plain_ms']:.3f} ms, "
              f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}, {nbytes / 1e6:.1f} MB)")
    return rec


def exchange_sum(g_values, radius):
    """The value's gradient over the full rows from each BEV shard's
    ``[B, L, Hb + 2R, ...]`` gradient, summed as the halo exchange's backward
    sums it (``parallel/collectives.py::halo_exchange``): a shard's own rows,
    then shard j-1's bottom halo onto its first R rows, then shard j+1's top
    halo onto its last R rows."""
    import torch

    n, r = len(g_values), radius
    rows = g_values[0].shape[2] - 2 * r
    out = []
    for j, gv in enumerate(g_values):
        inner = gv[:, :, r:r + rows].clone()
        if j > 0:
            inner[:, :, :r] += g_values[j - 1][:, :, rows + r:]
        if j < n - 1:
            inner[:, :, rows - r:] += g_values[j + 1][:, :, :r]
        out.append(inner)
    return torch.cat(out, dim=2)


def row_halo_phase(rng) -> dict:
    """B1 and B2 in ``row_halo`` mode at the flagship shape (B=2, L=C=7,
    60x180, M=8, D=16, P=4, R=4), random offsets past the clamp:

    - a value with zero halo rows must give the zero-padded kernels' bits
      (B1's output; B2's g_offsets, g_weights and g_value on the inner rows);
    - over 2, 4 and 6 BEV shards, each shard's launch against the plain
      ``row_halo`` version (KERNEL_ATOL, BWD_ATOL) with a bitwise repeat; the
      shards composed (halos cut from the full map): B1's output and B2's
      g_offsets and g_weights bitwise equal to the unsharded kernels', B2's
      g_value, summed as the halo exchange sums it, bitwise equal on the rows
      that one shard's queries alone reach and within ROW_HALO_ATOL where two
      shards' halos add; each kernel's time on one shard beside its bound and
      the plain version's;
    - the counted run: ``ops/msda_sharded.py::compose_bev_shards`` through
      autograd over 2 shards, forward and backward, with every count set to 0
      just before and read just after: B1 and B2 each once per shard, in halo
      mode, and the result against the unsharded kernels as above.
    Returns the records of the kernel line."""
    import torch

    from mvdetr_tpu_torch.ops.msda_sharded import compose_bev_shards
    from mvdetr_tpu_torch.ops.msda_windowed import (
        ms_deform_attn_windowed, ms_deform_attn_windowed_bwd, msda_windowed_bwd, msda_windowed_fwd,
    )

    b, l, h, w, m, d, p, r = (ROW_HALO_ATTENTION[k] for k in "blhwmdpr")
    v, o, wg = attention_inputs(rng, b, l, h, w, m, d, p, r, integer=False)
    g = torch.from_numpy(rng.standard_normal((b, l, h, w, m * d), dtype=np.float32)).cuda()
    out_full = msda_windowed_fwd(v, o, wg, r)
    gv_full, go_full, gw_full = msda_windowed_bwd(v, o, wg, g, r)
    zero = v.new_zeros((b, l, r, w, m, d))
    padded = torch.cat([zero, v, zero], dim=2)

    out_zero = msda_windowed_fwd(padded, o, wg, r, row_halo=True)
    gv_zero, go_zero, gw_zero = msda_windowed_bwd(padded, o, wg, g, r, row_halo=True)
    torch.cuda.synchronize()
    check(torch.equal(out_zero, out_full), "row_halo: B1 on zero halo rows differs from the zero-padded kernel")
    check(torch.equal(go_zero, go_full) and torch.equal(gw_zero, gw_full),
          "row_halo: B2's query side on zero halo rows differs from the zero-padded kernel")
    check(torch.equal(gv_zero[:, :, r:r + h], gv_full), "row_halo: B2's g_value on zero halo rows differs on the "
          "inner rows")
    print(f"row_halo: zero halo rows at the flagship shape give the zero-padded kernels' bits (B1; B2's g_offsets, "
          f"g_weights, and g_value on the {h} inner rows)")

    recs = {"fwd": {"errs": [], "by_shards": {}}, "bwd": {"errs": [], "by_shards": {}}}
    for n in ROW_HALO_SHARDS:
        rows = h // n
        outs, grads = [], []
        for j in range(n):
            cut = slice(j * rows, (j + 1) * rows)
            vh = padded[:, :, j * rows:j * rows + rows + 2 * r].contiguous()
            oj, wj, gj = (t[:, :, cut].contiguous() for t in (o, wg, g))
            out = msda_windowed_fwd(vh, oj, wj, r, row_halo=True)
            bwd = msda_windowed_bwd(vh, oj, wj, gj, r, row_halo=True)
            again, bwd_again = msda_windowed_fwd(vh, oj, wj, r, row_halo=True), msda_windowed_bwd(
                vh, oj, wj, gj, r, row_halo=True)
            ref = ms_deform_attn_windowed(vh, oj, wj, r, flatten=False, row_halo=True)
            ref_bwd = ms_deform_attn_windowed_bwd(vh, oj, wj, gj, r, row_halo=True)
            torch.cuda.synchronize()
            check(torch.equal(out, again) and all(torch.equal(x, y) for x, y in zip(bwd, bwd_again)),
                  f"row_halo n={n} shard {j}: two launches differ")
            recs["fwd"]["errs"].append(float((out - ref).abs().max()))
            check(recs["fwd"]["errs"][-1] <= KERNEL_ATOL, f"row_halo n={n} shard {j}: B1 error {recs['fwd']['errs'][-1]}")
            for what, x, y in zip(("g_value", "g_offsets", "g_weights"), bwd, ref_bwd):
                err, scale = float((x - y).abs().max()), float(y.abs().max())
                recs["bwd"]["errs"].append(err)
                check(err <= BWD_ATOL * max(1.0, scale), f"row_halo n={n} shard {j}: B2 {what} error {err}")
            outs.append(out)
            grads.append(bwd)
            if j == 0:  # one shard timed: every shard has the same shape
                fwd_bytes = vh.numel() * 2 + (oj.numel() + wj.numel() + out.numel()) * 4
                bwd_bytes = vh.numel() * 2 + (oj.numel() + wj.numel() + gj.numel() + sum(x.numel() for x in bwd)) * 4
                shard = {"fwd": bound(fwd_bytes, 10 * out.numel() * l * p),
                         "bwd": bound(bwd_bytes, BWD_FLOP_PER_SAMPLE_CHANNEL * wj.numel() * d)}
                shard["fwd"].update(ms=cuda_ms(lambda: msda_windowed_fwd(vh, oj, wj, r, row_halo=True), 20),
                                    plain_ms=cuda_ms(lambda: ms_deform_attn_windowed(
                                        vh, oj, wj, r, flatten=False, row_halo=True), 3))
                shard["bwd"].update(ms=cuda_ms(lambda: msda_windowed_bwd(vh, oj, wj, gj, r, row_halo=True), 10),
                                    plain_ms=cuda_ms(lambda: ms_deform_attn_windowed_bwd(
                                        vh, oj, wj, gj, r, row_halo=True), 2))
        out_sh = torch.cat(outs, dim=2)
        gv_sh = exchange_sum([x[0] for x in grads], r)
        go_sh, gw_sh = (torch.cat([x[i] for x in grads], dim=2) for i in (1, 2))
        inner = torch.from_numpy(reached_by_one_shard(h, n, r)).cuda()
        gv_err = float((gv_sh - gv_full).abs().max())
        gv_scale = float(gv_full.abs().max())
        check(torch.equal(out_sh, out_full), f"row_halo n={n}: the composed B1 output differs from the unsharded one")
        check(torch.equal(go_sh, go_full) and torch.equal(gw_sh, gw_full),
              f"row_halo n={n}: the composed g_offsets or g_weights differ from the unsharded ones")
        check(torch.equal(gv_sh[:, :, inner], gv_full[:, :, inner]), f"row_halo n={n}: g_value differs on rows "
              "that one shard's queries alone reach")
        check(gv_err <= ROW_HALO_ATOL * max(1.0, gv_scale), f"row_halo n={n}: g_value error {gv_err}")
        for key in ("fwd", "bwd"):
            recs[key]["by_shards"][n] = dict(shard[key], rows=rows)
        print(f"row_halo n={n} ({rows} rows + 2x{r} halo a shard): B1 and B2 on every shard within "
              f"{KERNEL_ATOL}/{BWD_ATOL} of their plain versions, bitwise repeats; composed B1 output, g_offsets "
              f"and g_weights bitwise the unsharded kernels'; g_value bitwise on {int(inner.sum())} of {h} rows, "
              f"max_abs_err {gv_err:.3e} (max |ref| {gv_scale:.3f}); one shard: B1 {shard['fwd']['ms']:.4f} ms "
              f"(bound {shard['fwd']['bound_ms']:.4f}, plain {shard['fwd']['plain_ms']:.3f}), B2 "
              f"{shard['bwd']['ms']:.4f} ms (bound {shard['bwd']['bound_ms']:.4f}, plain "
              f"{shard['bwd']['plain_ms']:.3f}); {torch.cuda.get_device_name(0)}")

    # the counted run: the one-process composition through autograd, value in f32 (staged in bf16 by the kernels)
    n = ROW_HALO_SHARDS[0]
    leaves = [v.float().requires_grad_(), o.clone().requires_grad_(), wg.clone().requires_grad_()]
    for fn in (msda_windowed_fwd, msda_windowed_bwd):
        fn.launches = fn.row_halo_launches = 0
    out = compose_bev_shards(*leaves, n, r)
    out.backward(g)
    torch.cuda.synchronize()
    launches = {fn.__name__: (fn.launches, fn.row_halo_launches) for fn in (msda_windowed_fwd, msda_windowed_bwd)}
    print(f"row_halo counted run (compose_bev_shards over {n} shards, forward and backward): launches (all, in halo "
          f"mode) {launches}")
    check(launches == {"msda_windowed_fwd": (n, n), "msda_windowed_bwd": (n, n)},
          f"row_halo counted run: launches {launches}")
    check(torch.equal(out, out_full), "row_halo counted run: the output differs from the unsharded kernel's")
    check(torch.equal(leaves[1].grad, go_full) and torch.equal(leaves[2].grad, gw_full),
          "row_halo counted run: g_offsets or g_weights differ from the unsharded kernel's")
    err = float((leaves[0].grad - gv_full).abs().max())
    check(err <= ROW_HALO_ATOL * max(1.0, float(gv_full.abs().max())), f"row_halo counted run: g_value error {err}")
    for key, fn in (("fwd", msda_windowed_fwd), ("bwd", msda_windowed_bwd)):
        recs[key]["launches"] = fn.row_halo_launches
        recs[key].update(recs[key]["by_shards"][n])
    recs["unsharded_ms"] = {"fwd": cuda_ms(lambda: msda_windowed_fwd(v, o, wg, r), 20),
                            "bwd": cuda_ms(lambda: msda_windowed_bwd(v, o, wg, g, r), 10)}
    print(f"row_halo: the unsharded kernels at the same shape in this run: B1 {recs['unsharded_ms']['fwd']:.4f} ms, "
          f"B2 {recs['unsharded_ms']['bwd']:.4f} ms")
    return recs


def view_phase(rng) -> dict:
    """Camera sharding's kernels, the view ranks composed in one process, at
    the flagship's attention shape (B=2, 60x180, M=8, D=16, P=4, R=4, bf16
    value, random offsets past the clamp) and its warp, for each (cameras,
    V) of VIEW_CASES (7 cameras over 7 ranks; a 6-camera rig of the same
    width over 2 and 3):

    - B1 on each rank's C = N / V query blocks over all N levels: bitwise the
      unsharded kernel's blocks; B2 there: g_offsets and g_weights bitwise the
      unsharded blocks, g_value summed over the ranks in rank order within
      VIEW_GV_ATOL of the unsharded one;
    - B3 on each rank's cameras' rows of g (the bench rig's homographies under
      a train batch's affines, bf16 g [B*N, 21600, 128]): bitwise the
      unsharded kernel's camera slices;
    - one rank's B1, B2 and B3 timed beside their bounds and plain versions;
    - the counted run at 7 ranks (``composed_view_shards``): every rank's
      attention through autograd (``windowed_attention`` on its query blocks,
      one value leaf) and its cameras' warp (the warp's sampling function on
      its rows of the feature map, B3 as backward), forward and backward,
      with every count set to 0 just before and read just after: B1, B2 and
      B3 once a rank, the results as above.
    Returns the records of the kernel line."""
    import torch

    from mvdetr_tpu_torch.ops.msda_windowed import (
        ms_deform_attn_windowed, ms_deform_attn_windowed_bwd, msda_windowed_bwd, msda_windowed_fwd,
        windowed_attention,
    )
    from mvdetr_tpu_torch.ops.sampling import bilinear_scatter_matmul
    from mvdetr_tpu_torch.ops.warp import _PatchSampleFn, warp_bwd

    b, h, w, m, d, p, r = (ROW_HALO_ATTENTION[k] for k in "bhwmdpr")
    recs = {"by_shards": {}}
    for cams, views in VIEW_CASES:
        per = cams // views
        v, o, wg = attention_inputs(rng, b, cams, h, w, m, d, p, r, integer=False)
        g = torch.from_numpy(rng.standard_normal((b, cams, h, w, m * d), dtype=np.float32)).cuda()
        out_full = msda_windowed_fwd(v, o, wg, r)
        gv_full, go_full, gw_full = msda_windowed_bwd(v, o, wg, g, r)
        rig = bench_rig(cams)
        warp = warp_flagship_inputs(rng, rig, train_batch(rig, b, world_reduce=4, img_reduce=12, seed=1))
        b3_full = warp_bwd(warp["g"], warp["sx"], warp["sy"], warp["h"], warp["w"])
        gv_sum = None
        for j in range(views):
            blk = slice(j * per, (j + 1) * per)
            oj, wj, gj = (t[:, blk].contiguous() for t in (o, wg, g))
            out = msda_windowed_fwd(v, oj, wj, r)
            gv, go, gw = msda_windowed_bwd(v, oj, wj, gj, r)
            rows = torch.tensor([i * cams + c for i in range(b) for c in range(j * per, (j + 1) * per)], device="cuda")
            wj_args = [warp[k].index_select(0, rows).contiguous() for k in ("g", "sx", "sy")]
            b3 = warp_bwd(*wj_args, warp["h"], warp["w"])
            torch.cuda.synchronize()
            check(torch.equal(out, out_full[:, blk]), f"view {cams}/{views} rank {j}: B1 differs from the unsharded "
                  "kernel's query blocks")
            check(torch.equal(go, go_full[:, blk]) and torch.equal(gw, gw_full[:, blk]),
                  f"view {cams}/{views} rank {j}: B2's g_offsets or g_weights differ from the unsharded blocks")
            check(torch.equal(b3, b3_full.index_select(0, rows)), f"view {cams}/{views} rank {j}: B3 differs from "
                  "the unsharded kernel's camera slices")
            gv_sum = gv.clone() if gv_sum is None else gv_sum.add_(gv)
            if j == 0:  # one rank timed: every rank has the same shapes
                fwd_bytes = v.numel() * 2 + (oj.numel() + wj.numel() + out.numel()) * 4
                bwd_bytes = v.numel() * 2 + (oj.numel() + wj.numel() + gj.numel() + gv.numel() + go.numel()
                                             + gw.numel()) * 4
                wg_, wsx, wsy = wj_args
                b3_bytes = (wg_.numel() + b3.numel()) * wg_.element_size() + (wsx.numel() + wsy.numel()) * 4
                rank = {"fwd": bound(fwd_bytes, 10 * out.numel() * cams * p),
                        "bwd": bound(bwd_bytes, BWD_FLOP_PER_SAMPLE_CHANNEL * wj.numel() * d),
                        "b3": bound(b3_bytes, 3 * 4 * wg_.numel())}
                rank["fwd"].update(ms=cuda_ms(lambda: msda_windowed_fwd(v, oj, wj, r), 20),
                                   plain_ms=cuda_ms(lambda: ms_deform_attn_windowed(v, oj, wj, r, flatten=False), 3))
                rank["bwd"].update(ms=cuda_ms(lambda: msda_windowed_bwd(v, oj, wj, gj, r), 10),
                                   plain_ms=cuda_ms(lambda: ms_deform_attn_windowed_bwd(v, oj, wj, gj, r), 2))
                rank["b3"].update(ms=cuda_ms(lambda: warp_bwd(*wj_args, warp["h"], warp["w"]), 20),
                                  plain_ms=cuda_ms(lambda: bilinear_scatter_matmul(*wj_args, warp["h"], warp["w"]),
                                                   3),
                                  library_ms=grid_sampler_backward_ms(*wj_args, warp["h"], warp["w"],
                                                                      warp["bev_hw"])[0])
        gv_err, gv_scale = float((gv_sum - gv_full).abs().max()), float(gv_full.abs().max())
        check(gv_err <= VIEW_GV_ATOL * max(1.0, gv_scale), f"view {cams}/{views}: g_value summed over the ranks "
              f"differs by {gv_err} (scale {gv_scale})")
        unsharded = {"fwd": cuda_ms(lambda: msda_windowed_fwd(v, o, wg, r), 20),
                     "bwd": cuda_ms(lambda: msda_windowed_bwd(v, o, wg, g, r), 10),
                     "b3": cuda_ms(lambda: warp_bwd(warp["g"], warp["sx"], warp["sy"], warp["h"], warp["w"]), 20)}
        for key in rank:
            rank[key]["unsharded_ms"] = unsharded[key]
        recs["by_shards"][f"{cams}/{views}"] = dict(rank, cameras_per_rank=per, g_value_err=gv_err)
        print(f"view {cams} cameras over {views} ranks ({per} a rank): B1 and B2 on every rank's {per} query "
              f"block(s) over {cams} levels bitwise the unsharded blocks (output, g_offsets, g_weights), g_value "
              f"summed in rank order within {gv_err:.3e} (max |ref| {gv_scale:.3f}, bound "
              f"{VIEW_GV_ATOL * max(1.0, gv_scale):.3e}); B3 on every rank's {b * per} camera rows bitwise the "
              f"unsharded slices; one rank: B1 {rank['fwd']['ms']:.4f} ms (bound {rank['fwd']['bound_ms']:.4f}, "
              f"plain {rank['fwd']['plain_ms']:.3f}, unsharded {unsharded['fwd']:.4f}), B2 {rank['bwd']['ms']:.4f} "
              f"ms (bound {rank['bwd']['bound_ms']:.4f}, plain {rank['bwd']['plain_ms']:.3f}, unsharded "
              f"{unsharded['bwd']:.4f}), B3 {rank['b3']['ms']:.4f} ms (bound {rank['b3']['bound_ms']:.4f}, plain "
              f"{rank['b3']['plain_ms']:.3f}, grid_sampler_2d_backward {rank['b3']['library_ms']:.4f}, unsharded "
              f"{unsharded['b3']:.4f}); {torch.cuda.get_device_name(0)}")
        if (cams, views) == VIEW_CASES[0]:
            counted = (v, o, wg, g, out_full, gv_full, go_full, gw_full, warp, b3_full)

    # the counted run: the 7 ranks composed through autograd, each rank's attention and its cameras' warp
    v, o, wg, g, out_full, gv_full, go_full, gw_full, warp, b3_full = counted
    cams, views = VIEW_CASES[0]
    per = cams // views
    wrappers = main_path_launches()
    feats = torch.from_numpy(rng.standard_normal((b * cams, warp["h"], warp["w"], warp["g"].shape[2]),
                                                 dtype=np.float32)).cuda().to(warp["g"].dtype).requires_grad_()
    leaves = [v.float().requires_grad_(), o.clone().requires_grad_(), wg.clone().requires_grad_()]
    rows = [torch.tensor([i * cams + c for i in range(b) for c in range(j * per, (j + 1) * per)], device="cuda")
            for j in range(views)]
    for fn in wrappers.values():
        fn.launches = 0
    outs, warped = [], []
    for j in range(views):
        blk = slice(j * per, (j + 1) * per)
        outs.append(windowed_attention(leaves[0], leaves[1][:, blk], leaves[2][:, blk], r, flatten=False))
        warped.append(_PatchSampleFn.apply(feats.index_select(0, rows[j]), warp["sx"].index_select(0, rows[j]),
                                           warp["sy"].index_select(0, rows[j])))
    out = torch.cat(outs, dim=1)
    torch.autograd.backward([out] + warped, [g] + [warp["g"].index_select(0, rows[j]) for j in range(views)])
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    print(f"view counted run (composed_view_shards: {views} ranks' attention and warp, forward and backward): "
          f"launches {launches}")
    check(launches == {name: views for name in wrappers}, f"view counted run: launches {launches}")
    check(torch.equal(out, out_full), "view counted run: the output differs from the unsharded kernel's")
    check(torch.equal(leaves[1].grad, go_full) and torch.equal(leaves[2].grad, gw_full),
          "view counted run: g_offsets or g_weights differ from the unsharded kernel's")
    err = float((leaves[0].grad - gv_full).abs().max())
    check(err <= VIEW_GV_ATOL * max(1.0, float(gv_full.abs().max())), f"view counted run: g_value error {err}")
    check(torch.equal(feats.grad, b3_full), "view counted run: the warp's input gradient differs from the "
          "unsharded B3's")
    recs["launches"] = launches
    recs["g_value_err"] = err
    return recs


def reached_by_one_shard(h, n, r) -> np.ndarray:
    """The value rows whose taps all come from queries of their own BEV shard
    (a query at row q taps rows q + floor(oy) and q + floor(oy) + 1, so row y
    is reached from query rows [y - r - 1, y + r])."""
    y, rows = np.arange(h), h // n
    lo, hi = np.clip(y - r - 1, 0, h - 1) // rows, np.clip(y + r, 0, h - 1) // rows
    return (lo == y // rows) & (hi == y // rows)


def warp_case(name, g, sx, sy, h, w, bev_hw=None, exact=False, ref_xy=None, scaled=False):
    """B3 vs the plain version on the card (bitwise equal to it when
    ``exact``: every partial sum of the case is exact in f32); timed when the
    samples' BEV grid ``bev_hw`` is given. ``ref_xy``: the coordinates the
    plain version takes instead of ``sx, sy``, on which B3 must give the same
    bits (NaN replaced by a coordinate that matches no cell: the dense
    one-hot product turns 0 * NaN into NaN, the kernel matches no cell).
    The bound is rtol (bf16 only) plus 1e-5, times ``max(1, max|ref|)`` when
    ``scaled`` (gather's cells sum a hundred or more taps of a weighted
    cotangent, of order 10). Returns a record."""
    import torch

    from mvdetr_tpu_torch.ops.sampling import bilinear_scatter_matmul
    from mvdetr_tpu_torch.ops.warp import warp_bwd

    out = warp_bwd(g, sx, sy, h, w)
    again = warp_bwd(g, sx, sy, h, w)
    if ref_xy is not None:
        check(torch.equal(out, warp_bwd(g, *ref_xy, h, w)), f"B3 {name}: NaN coordinates do not vanish")
    ref = bilinear_scatter_matmul(g, *(ref_xy or (sx, sy)), h, w)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    rtol = WARP_RTOL if g.dtype == torch.bfloat16 else 0.0
    worst = float((diff - rtol * ref.float().abs()).max()) / (max(1.0, float(ref.float().abs().max())) if scaled
                                                               else 1.0)
    print(f"B3 {name}: g {tuple(g.shape)} {g.dtype} -> {tuple(out.shape)}, max_abs_err={err:.3e} "
          f"(max |ref| {float(ref.float().abs().max()):.3f}), taps inside the map "
          f"{float(((sx >= -1) & (sx <= w) & (sy >= -1) & (sy <= h)).float().mean()):.3f}, bitwise repeat"
          + (", bitwise equal to the plain version" if exact else ""))
    check(bool(torch.isfinite(out).all()), f"B3 {name}: non-finite output")
    check(worst <= 1e-5, f"B3 {name}: error {err} beyond rtol {rtol} + 1e-5" + (" of scale" if scaled else ""))
    check(torch.equal(out, again), f"B3 {name}: two launches differ")
    check(not exact or torch.equal(out, ref), f"B3 {name}: not bitwise equal to the plain version")
    rec = {"err": err}
    if bev_hw is not None:
        nbytes = (g.numel() + out.numel()) * g.element_size() + (sx.numel() + sy.numel()) * 4
        rec.update(bound(nbytes, 3 * 4 * g.numel()))  # per (query, tap, channel): 2 mul + 1 add
        rec["ms"] = cuda_ms(lambda: warp_bwd(g, sx, sy, h, w), 20)
        rec["plain_ms"] = cuda_ms(lambda: bilinear_scatter_matmul(g, sx, sy, h, w), 3)
        rec["library_ms"], lib_dtype = grid_sampler_backward_ms(g, sx, sy, h, w, bev_hw)
        print(f"B3 {name}: kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.3f} ms, grid_sampler_2d_backward "
              f"({lib_dtype}) {rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}, "
              f"{nbytes / 1e6:.1f} MB)")
    return rec


def warp_flagship_inputs(rng, rig=None, batch=None, device="cuda", dtype=None) -> dict:
    """B3's inputs on the main path: the source coordinates of a rig's
    homographies (the bench rig's unless given) under a train batch's
    augmentation affines (``train_batch(rig, 2, ..., seed=0)`` unless given),
    from the trunk's stride-8 feature map of the batch's frames, and g
    [B * cameras, BEV cells, 128] from ``rng`` in ``dtype`` (bf16 unless
    given), on the card by default."""
    import torch

    from mvdetr_tpu_torch.models import MVDeTr
    from mvdetr_tpu_torch.ops.warp import warp_coords

    rig = bench_rig() if rig is None else rig
    batch = train_batch(rig, 2, world_reduce=4, img_reduce=12, seed=0) if batch is None else batch
    b, n, img_h, img_w = batch["imgs"].shape[:4]
    h, w = -(-img_h // 8), -(-img_w // 8)  # the trunk's feature map (720x1280 frames -> 90x160)
    geo = MVDeTr.from_rig(rig, world_reduce=4, img_reduce=12, device=device)  # the path's homographies
    mats = geo.warp_mats(torch.from_numpy(batch["affine_mats"]).to(device), (h, w))
    sx, sy = warp_coords(mats, geo.Rworld_shape)
    g = torch.from_numpy(rng.standard_normal((b * n, sx.shape[1], 128), dtype=np.float32)).to(
        device, torch.bfloat16 if dtype is None else dtype)
    return {"g": g, "sx": sx.contiguous(), "sy": sy.contiguous(), "h": h, "w": w, "bev_hw": geo.Rworld_shape}


WARP_STRESS_NAMES = ("one-cell", "segment-lengths", "all-outside", "nan-far", "C5-f32", "C40-f32", "C300-bf16",
                     "sentinel-top-bit", "misaligned")


def warp_stress_cases(rng, device="cuda") -> dict:
    """B3's stress cases (on the card by default): name -> ``g, sx, sy, h,
    w``, ``exact`` (every partial sum exact in f32, so the kernel must equal
    the plain version bitwise) and ``ref_xy`` (coordinates for the plain
    version, or None: see :func:`warp_case`)."""
    import torch

    def case(g, sx, sy, h, w, dtype=torch.bfloat16, exact=False):
        f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)  # noqa: E731
        return {"g": f32(g).to(dtype), "sx": f32(sx), "sy": f32(sy), "h": h, "w": w, "exact": exact, "ref_xy": None}

    def uniform(b, q, h, w):
        return rng.uniform(-2.0, w + 1.0, (b, q)), rng.uniform(-2.0, h + 1.0, (b, q))

    cases = {}
    # every query on one cell: four segments of 3000 entries; g small integers
    # and fractions k/16, so every term and partial sum is exact
    q = 3000
    cases["one-cell"] = case(rng.integers(-8, 9, (1, q, 128)), 6 + rng.integers(0, 16, (1, q)) / 16,
                             4 + rng.integers(0, 16, (1, q)) / 16, 11, 17, exact=True)
    # segment lengths around the walk's batch (32) and its loads in flight (4):
    # group i puts n_i queries on the 2x2 cells at (1 + 3*(i // 6), 1 + 3*(i % 6)),
    # in a shuffled query order
    lengths = (1, 3, 4, 5, 7, 8, 9, 31, 32, 33, 63, 64, 65, 97)
    base = np.repeat([(1 + 3 * (i // 6), 1 + 3 * (i % 6)) for i in range(len(lengths))], lengths, axis=0)
    perm = np.stack([rng.permutation(len(base)) for _ in range(2)])
    frac = rng.uniform(0.0, 0.999, (2, len(base), 2))
    cases["segment-lengths"] = case(rng.standard_normal((2, len(base), 128)), base[perm, 1] + frac[..., 0],
                                    base[perm, 0] + frac[..., 1], 10, 19)
    # every tap outside: left of column -1 or right of the last column
    q = 900
    sx = np.where(rng.random((2, q)) < 0.5, rng.uniform(-40.0, -2.0, (2, q)), rng.uniform(17.0, 60.0, (2, q)))
    cases["all-outside"] = case(rng.standard_normal((2, q, 128)), sx, rng.uniform(-2.0, 12.0, (2, q)), 11, 17)
    # NaN and +-1e6 coordinates among ordinary ones
    sx, sy = uniform(2, q, 11, 17)
    pick = rng.integers(0, 5, (2, q))
    sx = np.where(pick == 0, np.nan, np.where(pick == 1, 1e6, sx))
    sy = np.where(pick == 2, np.nan, np.where(pick == 3, -1e6, sy))
    nan_far = case(rng.standard_normal((2, q, 128)), sx, sy, 11, 17)
    nan_far["ref_xy"] = (torch.nan_to_num(nan_far["sx"], nan=-1e6), torch.nan_to_num(nan_far["sy"], nan=-1e6))
    cases["nan-far"] = nan_far
    # channel counts: scalar lanes (C=5), a partial vector pass (C=40), three passes (C=300)
    cases["C5-f32"] = case(rng.standard_normal((3, 700, 5)), *uniform(3, 700, 11, 17), 11, 17, dtype=torch.float32)
    cases["C40-f32"] = case(rng.standard_normal((3, 700, 40)), *uniform(3, 700, 11, 17), 11, 17,
                            dtype=torch.float32)
    cases["C300-bf16"] = case(rng.standard_normal((2, 500, 300)), *uniform(2, 500, 9, 13), 9, 13)
    # B*H*W = 1024: the sentinel 1024 is the top bit of an 11-bit sort
    cases["sentinel-top-bit"] = case(rng.standard_normal((2, 1200, 64)), *uniform(2, 1200, 16, 32), 16, 32)
    # g at a 2-byte offset: contiguous but not 8-byte aligned, so the lanes load scalars
    misaligned = case(rng.standard_normal((2 * 600 * 128 + 1,)), *uniform(2, 600, 11, 17), 11, 17)
    misaligned["g"] = misaligned["g"][1:].view(2, 600, 128)
    cases["misaligned"] = misaligned
    check(tuple(cases) == WARP_STRESS_NAMES, f"B3 stress cases {tuple(cases)} are not WARP_STRESS_NAMES")
    return cases


def warp_segment_stats(sx, sy, h, w) -> dict:
    """Entries per destination cell of B3 at these coordinates, counted with
    plain tensor operations: cells, non-empty cells, taps inside, mean and
    largest segment over the non-empty cells."""
    import torch

    b = sx.shape[0]
    counts = torch.zeros(b * h * w, dtype=torch.int64, device=sx.device)
    bidx = torch.arange(b, device=sx.device)[:, None]
    for ty in (0, 1):
        for tx in (0, 1):
            xx, yy = torch.floor(sx) + tx, torch.floor(sy) + ty
            inside = (xx >= 0) & (xx <= w - 1) & (yy >= 0) & (yy <= h - 1)
            key = (bidx * h + yy.clamp(0, h - 1).long()) * w + xx.clamp(0, w - 1).long()
            counts += torch.bincount(key[inside], minlength=b * h * w)
    seg = counts[counts > 0].double()
    return {"cells": b * h * w, "nonempty": int(seg.numel()), "entries_inside": int(counts.sum()),
            "entries": 4 * sx.numel(), "mean": float(seg.mean()), "p90": float(seg.quantile(0.9)),
            "p99": float(seg.quantile(0.99)), "max": int(seg.max())}


def device_activities(prof) -> list:
    """The device activities of a torch.profiler run, summed by name:
    kernels, memsets and copies."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.key.startswith("Activity Buffer")]


MEMSET = "Memset (Device)"  # torch.profiler's name for a cudaMemsetAsync on the card
# a B3 stage's kernels by a part of their names; the sort is all else a call runs (CUB's kernels and memset)
WARP_STAGE_KERNELS = (("keys_kernel", "keys"), ("starts_kernel", "starts"), ("gather_kernel", "gather"))


def warp_stage_ms(fn, reps: int = 10) -> dict:
    """Device time of one B3 call ``fn`` by stage (keys, sort, starts,
    gather; a source with no starts pass has none), the mean over ``reps``
    calls traced by torch.profiler after a warm-up, and ``"all"``, their sum."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    stages: dict[str, float] = {}
    for e in device_activities(prof):
        stage = next((s for part, s in WARP_STAGE_KERNELS if part in e.key), "sort")
        stages[stage] = stages.get(stage, 0.0) + e.self_device_time_total / 1e3 / reps
    stages["all"] = sum(stages.values())
    return stages


def profile_call(fn):
    """A torch.profiler run of one call of ``fn`` after a warm-up call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof


def grid_sampler_backward_ms(g, sx, sy, h, w, bev_hw):
    """Time of the one PyTorch call that computes B3's function: the input
    gradient of ``grid_sampler_2d`` (bilinear, zero padding,
    ``align_corners=False``) with the pixel coordinates normalised. A
    yardstick only; the port never calls it (it scatters with float atomics)."""
    import torch

    b, _, c = g.shape
    ho, wo = bev_hw
    grid = torch.stack([(2 * sx + 1) / w - 1, (2 * sy + 1) / h - 1], -1).reshape(b, ho, wo, 2)
    for dt in (g.dtype, torch.float32):
        gout = g.to(dt).reshape(b, ho, wo, c).permute(0, 3, 1, 2)
        inp = torch.zeros((b, c, h, w), dtype=dt, device=g.device)
        fn = lambda: torch.ops.aten.grid_sampler_2d_backward(  # noqa: E731
            gout, inp, grid.to(dt), 0, 0, False, [True, False])
        try:
            return cuda_ms(fn, 20), str(dt).replace("torch.", "")
        except RuntimeError as e:  # a dtype the library call does not take: time it in f32
            print(f"B3: grid_sampler_2d_backward refuses {dt}: {str(e)[:120]}")
    raise RuntimeError("chip_smoke: grid_sampler_2d_backward ran in no dtype")


def warp_phase(rng, rig, batch) -> dict:
    """B3 at the flagship (timed, with its segments), at a narrow f32 shape
    and at the stress cases. Returns a record."""
    import torch

    from mvdetr_tpu_torch.geometry import make_synthetic_rig

    flag = warp_flagship_inputs(rng, rig, batch)
    g, sx, sy, h, w = (flag[k] for k in ("g", "sx", "sy", "h", "w"))
    seg = warp_segment_stats(sx, sy, h, w)
    print(f"B3 flagship segments: {seg['nonempty']} of {seg['cells']} cells get a tap, {seg['entries_inside']} of "
          f"{seg['entries']} entries inside; entries per non-empty cell mean {seg['mean']:.2f}, p90 "
          f"{seg['p90']:.0f}, p99 {seg['p99']:.0f}, largest {seg['max']}")
    b3 = warp_case("flagship", g, sx, sy, h, w, bev_hw=flag["bev_hw"])
    b3["segments"] = seg
    small = torch.from_numpy(rng.standard_normal((3, 700, 40), dtype=np.float32)).cuda()
    nx = torch.from_numpy(rng.uniform(-2.0, 18.0, (3, 700)).astype(np.float32)).cuda()
    ny = torch.from_numpy(rng.uniform(-2.0, 12.0, (3, 700)).astype(np.float32)).cuda()
    b3["errs"] = [b3["err"], warp_case("narrow-f32", small, nx, ny, 11, 17)["err"]]
    for name, c in warp_stress_cases(rng).items():
        b3["errs"].append(warp_case(name, c["g"], c["sx"], c["sy"], c["h"], c["w"], exact=c["exact"],
                                    ref_xy=c["ref_xy"])["err"])
    # the cli recipe's and the convergence rigs' B3: batch 1, f32 (no --bf16), at each rig's coordinates
    for name, rig_kw in CONVERGENCE_RIGS.items():
        rrig = make_synthetic_rig(**rig_kw)
        rbatch = train_batch(rrig, 1, world_reduce=4, img_reduce=12, seed=0, num_person=8)
        c = warp_flagship_inputs(rng, rrig, rbatch, dtype=torch.float32)
        b3["errs"].append(warp_case(f"recipe-{name}", c["g"], c["sx"], c["sy"], c["h"], c["w"])["err"])
    del flag, g, small
    torch.cuda.empty_cache()
    return b3


def warp_profile(b3, rig, batch, step_warp_kernels_ms: float) -> None:
    """B3's device time at the flagship coordinates by stage and by device
    activity, and its share of the train step: the step profile's kernels
    named warp_bwd (CUB's are in the namespace warp_bwd_cub) and the one
    memset of CUB's sort, measured here, since the step's memsets share one
    name. Run after the serve and train profiles: in this process a
    torch.profiler run before them left the pageable upload out of the serve
    profile."""
    import torch

    from mvdetr_tpu_torch.ops import warp
    from mvdetr_tpu_torch.ops.warp import warp_bwd

    flag = warp_flagship_inputs(np.random.default_rng(0), rig, batch)
    call = lambda: warp_bwd(*(flag[k] for k in ("g", "sx", "sy", "h", "w")))  # noqa: E731
    b3["device_ms"] = warp_stage_ms(call)
    acts = device_activities(profile_call(call))
    print("B3 flagship device time by stage: " + ", ".join(f"{k} {v:.4f} ms" for k, v in b3["device_ms"].items())
          + f"; one call's {len(acts)} device activities:")
    for e in sorted(acts, key=lambda e: -e.self_device_time_total):
        print(f"  {e.self_device_time_total / 1e3:9.4f} ms  {e.key[:140]}")
    others = {e.key for e in acts if warp.KERNEL_NAME not in e.key}
    check(others <= {MEMSET}, f"B3: device activities {others} are neither warp_bwd kernels nor a memset")
    b3["memset_ms"] = sum(e.self_device_time_total for e in acts if e.key == MEMSET) / 1e3
    b3["step_ms"] = step_warp_kernels_ms + b3["memset_ms"]
    print(f"train profile: B3 in the step {b3['step_ms']:.3f} ms: its kernels {step_warp_kernels_ms:.3f} ms and its "
          f"sort's memset {b3['memset_ms']:.4f} ms (one launch a step; the memset from B3's own profile)")
    del flag
    torch.cuda.empty_cache()


def shadow_warp_inputs(rng, rig=None, batch_size=2, dtype=None, device="cuda") -> dict:
    """B3's inputs on the shadow path: the pixel coordinates of a rig's
    8-point reference map (the bench rig's unless given) on its encoder grid,
    repeated over the batch as ``shadow_warp_stack`` repeats them, and g
    [B * cameras, H*W*8, 128] from ``rng`` in ``dtype`` (bf16 unless given),
    on the card by default. ``bev_hw`` lays the H*W*8 samples out as an
    (8H) x W grid for the library call."""
    import torch

    from mvdetr_tpu_torch.ops.msda_warped import shadow_coords

    rig = bench_rig() if rig is None else rig
    hb, wb = rig.Rworld_shape(4)
    h, w = hb // 2, wb // 2
    coords = shadow_coords(rig.reference_points(world_reduce=4, downsample=2, n_points=8), h, w).to(device)
    sx, sy = coords[0].repeat(batch_size, 1), coords[1].repeat(batch_size, 1)
    g = torch.from_numpy(rng.standard_normal((sx.shape[0], sx.shape[1], 128), dtype=np.float32)).to(
        device, torch.bfloat16 if dtype is None else dtype)
    return {"g": g, "sx": sx, "sy": sy, "h": h, "w": w, "bev_hw": (8 * h, w)}


def shadow_kernel_phase(rng, rig) -> dict:
    """B1, B2 and B3 at the shapes of the 8-point shadow path: B1 and B2 over
    the bench rig's 56 pseudo-levels (random offsets past the clamp, and the
    radial init of 7 cameras x 8 points shifted by integers; timed, B2 also
    by side), untimed at B=1 and B=4, and the recipe's 32, untimed; B3 at
    the bench rig's shadow coordinates in bf16 (timed, with its segments, its
    device time by stage and the library call) and in f32, and at the recipe
    rig's in f32.
    Returns a record per kernel, errors under ``"errs"``."""
    import torch

    from mvdetr_tpu_torch.geometry import make_synthetic_rig
    from mvdetr_tpu_torch.ops.warp import warp_bwd

    b1 = fwd_case("shadow-random", **SHADOW_ATTENTION, integer=False, rng=rng, timed=True)
    b1_int = fwd_case("shadow-integer", **SHADOW_ATTENTION, integer=True, rng=rng, timed=True)
    b2 = bwd_case("shadow-random", **SHADOW_ATTENTION, integer=False, rng=rng, timed=True)
    b2_int = bwd_case("shadow-integer", **SHADOW_ATTENTION, integer=True, rng=rng, timed=True)
    b1.update(errs=[b1["err"], b1_int["err"]], ms_integer=b1_int["ms"])
    b2.update(errs=[b2["err"], b2_int["err"]], ms_integer=b2_int["ms"])
    for batch_size in (1, 4):  # the block counts and 64-bit indices at other batches
        shape = dict(SHADOW_ATTENTION, b=batch_size)
        b1["errs"].append(fwd_case(f"shadow-B{batch_size}", **shape, integer=False, rng=rng, timed=False)["err"])
        b2["errs"].append(bwd_case(f"shadow-B{batch_size}", **shape, integer=False, rng=rng, timed=False)["err"])
    for integer in (False, True):
        label = f"recipe-shadow-{'integer' if integer else 'random'}"
        b1["errs"].append(fwd_case(label, **RECIPE_SHADOW_ATTENTION, integer=integer, rng=rng, timed=False)["err"])
        b2["errs"].append(bwd_case(label, **RECIPE_SHADOW_ATTENTION, integer=integer, rng=rng, timed=False)["err"])
    torch.cuda.empty_cache()

    c = shadow_warp_inputs(rng, rig)
    seg = warp_segment_stats(c["sx"], c["sy"], c["h"], c["w"])
    print(f"B3 shadow segments: {seg['nonempty']} of {seg['cells']} cells get a tap, {seg['entries_inside']} of "
          f"{seg['entries']} entries inside; entries per non-empty cell mean {seg['mean']:.2f}, p90 "
          f"{seg['p90']:.0f}, p99 {seg['p99']:.0f}, largest {seg['max']}")
    b3 = warp_case("shadow-bf16", c["g"], c["sx"], c["sy"], c["h"], c["w"], bev_hw=c["bev_hw"])
    b3["segments"] = seg
    b3["device_ms"] = warp_stage_ms(lambda: warp_bwd(c["g"], c["sx"], c["sy"], c["h"], c["w"]))
    print("B3 shadow device time by stage: " + ", ".join(f"{k} {v:.4f} ms" for k, v in b3["device_ms"].items()))
    c32 = dict(c, g=c["g"].float())
    b3["errs"] = [b3["err"], warp_case("shadow-f32", c32["g"], c["sx"], c["sy"], c["h"], c["w"])["err"]]
    del c, c32
    r = shadow_warp_inputs(rng, make_synthetic_rig(**CONVERGENCE_RIGS["xy"]), batch_size=1, dtype=torch.float32)
    b3["errs"].append(warp_case("recipe-shadow-f32", r["g"], r["sx"], r["sy"], r["h"], r["w"])["err"])
    torch.cuda.empty_cache()
    return {"b1": b1, "b2": b2, "b3": b3}


def gather_inputs(rng, b, l, h, w, m, d, p, reach=None, away=0.0, device="cuda"):
    """Gather attention's f32 inputs on ``l`` same-shape levels with every
    token a query (``Q = L*H*W``) at the identity grid map: the value
    ``[B, L, H, W, M, D]`` rounded to bf16 values (so B1's staging of it is
    exact), offsets ``[B, L, H, W, M, L, P, 2]`` uniform in ``+-reach`` (None:
    the unscaled radial init of gather mode, integers mostly; ``away > 0``:
    a whole part in ``[-reach, reach)`` plus a fraction at least ``away``
    from 0 and 1, so that no coordinate lies within rounding of a cell
    edge), weights
    softmaxed over (L, P), and the grid map ``[Q, 1, L, 1, 2]``. The windowed
    layouts are the gather layouts' bytes: ``value.view(b, l*h*w, m, d)``,
    ``offsets.view(b, l*h*w, m, l, p, 2)``."""
    import torch

    from mvdetr_tpu_torch.models.deformable import grid_reference_points, radial_offset_bias

    value = torch.from_numpy(rng.standard_normal((b, l, h, w, m, d), dtype=np.float32)).bfloat16().float()
    if reach is None:
        off = np.broadcast_to(radial_offset_bias(m, l, p).reshape(m, l, p, 2), (b, l, h, w, m, l, p, 2))
    elif away > 0:
        size = (b, l, h, w, m, l, p, 2)
        off = rng.integers(-int(reach), int(reach), size) + rng.uniform(away, 1.0 - away, size)
    else:
        off = rng.uniform(-reach, reach, (b, l, h, w, m, l, p, 2))
    logits = torch.from_numpy(rng.standard_normal((b, l, h, w, m, l * p), dtype=np.float32))
    wgt = torch.softmax(logits, -1).reshape(b, l, h, w, m, l, p)
    ref = torch.from_numpy(grid_reference_points(((h, w),) * l))[:, None, :, None, :]
    off = torch.from_numpy(np.ascontiguousarray(off, dtype=np.float32))
    return tuple(t.to(device) for t in (value, off, wgt, ref))


def gather_run(value, off, wgt, ref, g, shape, value_grad=True):
    """Gather attention's forward and backward (``g`` the output's
    cotangent) on the inputs' device through the path's entry points
    (``sampling_locations``, ``ms_deform_attn_gather``): returns ``(out,
    g_value, g_offsets, g_weights)``, ``g_value`` None unless
    ``value_grad``."""
    import torch

    from mvdetr_tpu_torch.models.deformable import sampling_locations
    from mvdetr_tpu_torch.ops.msda import ms_deform_attn_gather

    b, l, h, w, m, d, p = (shape[k] for k in ("b", "l", "h", "w", "m", "d", "p"))
    v = value.reshape(b, l * h * w, m, d).detach().requires_grad_(value_grad)
    o = off.reshape(b, l * h * w, m, l, p, 2).detach().requires_grad_()
    wg = wgt.reshape(b, l * h * w, m, l, p).to(value.dtype).detach().requires_grad_()
    out = ms_deform_attn_gather(v, (h, w), l, sampling_locations(ref, o, h, w), wg)
    out.backward(g.reshape(out.shape))
    return out.detach(), (v.grad if value_grad else None), o.grad, wg.grad


def _held(label, what, ours, ref, atol):
    """Check ``ours`` against ``ref`` within ``atol`` of ``max(1, scale)``; returns the error."""
    import torch

    err, scale = float((ours.float() - ref.float()).abs().max()), float(ref.float().abs().max())
    check(bool(torch.isfinite(ours).all()), f"{label}: non-finite {what}")
    check(scale > 0, f"{label}: {what} is all zeros")
    check(err <= atol * max(1.0, scale), f"{label}: {what} max abs error {err} (scale {scale}) > {atol} of scale")
    return err


def gather_card_vs_cpu(name, shape, rng, value_grad=True) -> float:
    """Gather attention on the card against the same entry points on the
    CPU, in f32, at random offsets: the output and the offsets' and
    weights' gradients, and the value's when ``value_grad`` (its plain CPU
    adjoint is a dense one-hot product: 11.7 TFLOP at the flagship, so it is
    held there against B1/B2 instead, by :func:`gather_vs_windowed`).
    Returns the largest error."""
    import torch

    cpu = gather_inputs(rng, **shape, reach=6.0, device="cpu")
    g = torch.from_numpy(rng.standard_normal((shape["b"], shape["l"] * shape["h"] * shape["w"],
                                              shape["m"] * shape["d"]), dtype=np.float32))
    t0 = time.perf_counter()
    ref = gather_run(*cpu, g, shape, value_grad)
    cpu_s = time.perf_counter() - t0
    card = gather_run(*(t.cuda() for t in cpu), g.cuda(), shape, value_grad)
    torch.cuda.synchronize()
    errs = [_held(f"gather {name} card vs cpu", what, a.cpu(), r, GATHER_ATOL)
            for what, a, r in zip(("output", "g_value", "g_offsets", "g_weights"), card, ref) if r is not None]
    print(f"gather {name} card vs cpu, f32: B={shape['b']} L={shape['l']} {shape['h']}x{shape['w']} M={shape['m']} "
          f"D={shape['d']} P={shape['p']}: max_abs_err output / " + ("g_value / " if value_grad else "")
          + "g_offsets / g_weights " + " / ".join(f"{e:.3e}" for e in errs) + f" (CPU {cpu_s:.1f} s)")
    return max(errs)


def gather_vs_windowed(rng, name, shape, radius=4) -> float:
    """The windowed = gather identity (`tests/test_msda_windowed.py:28-44`)
    on the card in f32: identity map, offsets inside ``+-(R-1)``, each at
    least 0.01 from an integer, so no clamp binds and B2's hat slope is
    gather's floor slope at every sample. B1/B2 through
    ``windowed_attention`` against gather (its value gradient from B3):
    output and all three gradients within ``GATHER_WINDOWED_ATOL[name]`` of
    scale. Returns the largest error."""
    import torch

    from mvdetr_tpu_torch.ops.msda_windowed import windowed_attention

    atol = GATHER_WINDOWED_ATOL[name]
    value, off, wgt, ref = gather_inputs(rng, **shape, reach=radius - 1.0, away=0.01)
    check(float(off.abs().max()) < radius - 1, "gather vs windowed: an offset outside +-(R-1)")
    b, l, h, w, m, d = (shape[k] for k in ("b", "l", "h", "w", "m", "d"))
    g = torch.from_numpy(rng.standard_normal((b, l * h * w, m * d), dtype=np.float32)).cuda()
    vw, ow, ww = (t.detach().requires_grad_() for t in (value, off, wgt))
    out_w = windowed_attention(vw, ow, ww, radius)
    out_w.backward(g)
    ours = gather_run(value, off, wgt, ref, g, shape)
    torch.cuda.synchronize()
    errs = [_held(f"gather vs B1/B2 {name}", what, a.reshape(r.shape), r, atol)
            for what, a, r in zip(("output", "g_value", "g_offsets", "g_weights"), ours,
                                  (out_w.detach(), vw.grad, ow.grad, ww.grad))]
    print(f"gather vs B1/B2 (windowed, R={radius}) {name}: B={b} L={l} {h}x{w} M={m} D={d}, f32, offsets inside "
          f"+-{radius - 1}: max_abs_err output / g_value / g_offsets / g_weights "
          + " / ".join(f"{e:.3e}" for e in errs) + f" (bound {atol} of scale)")
    return max(errs)


def gather_warp_inputs(rng, shape, dtype, reach=None, device="cuda") -> dict:
    """B3's inputs on gather mode's backward: the coordinates of
    :func:`gather_inputs`' locations (the radial init when ``reach`` is None)
    laid out as the backward launches them, ``[B*M*L, Q*P]``, and g
    ``[B*M*L, Q*P, D]`` from ``rng`` in ``dtype``. ``bev_hw`` lays the Q*P
    samples out as a grid for the library call."""
    import torch

    from mvdetr_tpu_torch.models.deformable import sampling_locations
    from mvdetr_tpu_torch.ops.msda import gather_coords

    b, l, h, w, m, d, p = (shape[k] for k in ("b", "l", "h", "w", "m", "d", "p"))
    _, off, _, ref = gather_inputs(rng, **shape, reach=reach, device=device)
    loc = sampling_locations(ref, off.reshape(b, l * h * w, m, l, p, 2), h, w)
    sx, sy = gather_coords(loc, h, w)
    g = torch.from_numpy(rng.standard_normal((sx.shape[0], sx.shape[1], d), dtype=np.float32)).to(device, dtype)
    return {"g": g, "sx": sx.contiguous(), "sy": sy.contiguous(), "h": h, "w": w, "bev_hw": (l * h * p, w)}


def gather_kernel_phase(rng) -> dict:
    """(g) gather attention on the card: against the CPU (the flagship's
    shape without the value's gradient, the recipe's with it), against
    B1/B2 at the flagship's shape, timed forward and backward in bf16; B3
    at the coordinates of the flagship's and aio's gather backward in bf16
    (timed, device time by stage, the library call) and f32, against its
    plain version with a bitwise repeat. Returns B3's record, errors under
    ``"errs"``, and the attention's times."""
    import torch

    from mvdetr_tpu_torch.ops.warp import warp_bwd

    errs = [gather_card_vs_cpu("flagship", GATHER_ATTENTION, rng, value_grad=False),
            gather_card_vs_cpu("recipe", RECIPE_GATHER_ATTENTION, rng),
            gather_card_vs_cpu("aio", AIO_ATTENTION, rng, value_grad=False),
            gather_vs_windowed(rng, "recipe", RECIPE_GATHER_ATTENTION),
            gather_vs_windowed(rng, "flagship", GATHER_ATTENTION)]
    torch.cuda.empty_cache()

    # one layer's attention at the flagship in bf16, as the model runs it: the plain gather forward, B3 backward
    value, off, wgt, ref = gather_inputs(rng, **GATHER_ATTENTION, reach=6.0)
    value = value.bfloat16()
    g = torch.from_numpy(rng.standard_normal((2, 7 * 60 * 180, 128), dtype=np.float32)).cuda().bfloat16()
    times = {"fwd_ms": cuda_ms(lambda: gather_forward(value, off, wgt, ref, GATHER_ATTENTION), 5),
             "fwd_bwd_ms": cuda_ms(lambda: gather_run(value, off, wgt, ref, g, GATHER_ATTENTION), 5)}
    print(f"gather attention, one layer at the flagship in bf16: forward {times['fwd_ms']:.3f} ms, forward and "
          f"backward {times['fwd_bwd_ms']:.3f} ms (B3 once)")
    del value, off, wgt, ref, g
    torch.cuda.empty_cache()

    c = gather_warp_inputs(rng, GATHER_ATTENTION, torch.bfloat16)
    seg = warp_segment_stats(c["sx"], c["sy"], c["h"], c["w"])
    print(f"B3 gather segments (radial init): {seg['nonempty']} of {seg['cells']} cells get a tap, "
          f"{seg['entries_inside']} of {seg['entries']} entries inside; entries per non-empty cell mean "
          f"{seg['mean']:.2f}, p90 {seg['p90']:.0f}, p99 {seg['p99']:.0f}, largest {seg['max']}")
    b3 = warp_case("gather-bf16", c["g"], c["sx"], c["sy"], c["h"], c["w"], bev_hw=c["bev_hw"], scaled=True)
    b3["segments"] = seg
    b3["device_ms"] = warp_stage_ms(lambda: warp_bwd(c["g"], c["sx"], c["sy"], c["h"], c["w"]))
    print("B3 gather device time by stage: " + ", ".join(f"{k} {v:.4f} ms" for k, v in b3["device_ms"].items()))
    del c
    torch.cuda.empty_cache()
    c = gather_warp_inputs(rng, GATHER_ATTENTION, torch.float32, reach=6.0)
    b3["errs"] = [b3["err"], warp_case("gather-f32", c["g"], c["sx"], c["sy"], c["h"], c["w"], scaled=True)["err"]]
    del c
    torch.cuda.empty_cache()
    c = gather_warp_inputs(rng, AIO_ATTENTION, torch.bfloat16)
    aio = warp_case("aio-bf16", c["g"], c["sx"], c["sy"], c["h"], c["w"], bev_hw=c["bev_hw"], scaled=True)
    b3["errs"].append(aio["err"])
    b3["aio"] = {k: aio[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    c32 = gather_warp_inputs(rng, AIO_ATTENTION, torch.float32, reach=6.0)
    b3["errs"].append(warp_case("aio-f32", c32["g"], c32["sx"], c32["sy"], c32["h"], c32["w"], scaled=True)["err"])
    del c, c32
    torch.cuda.empty_cache()
    return {"b3": b3, "errs": errs, "times": times}


def gather_forward(value, off, wgt, ref, shape):
    """Gather attention's forward alone (no autograd graph)."""
    import torch

    from mvdetr_tpu_torch.models.deformable import sampling_locations
    from mvdetr_tpu_torch.ops.msda import ms_deform_attn_gather

    b, l, h, w, m, d, p = (shape[k] for k in ("b", "l", "h", "w", "m", "d", "p"))
    with torch.no_grad():
        loc = sampling_locations(ref, off.reshape(b, l * h * w, m, l, p, 2), h, w)
        return ms_deform_attn_gather(value.reshape(b, l * h * w, m, d), (h, w), l, loc,
                                     wgt.reshape(b, l * h * w, m, l, p).to(value.dtype))


def deform_conv_warp_inputs(rng, shape=None, device="cuda") -> dict:
    """B3's inputs on deform_conv's input gradient: the taps' coordinates of
    a seeded ``DeformConvWorldFeat``'s offsets on a random BEV stack (as its
    forward forms them: each map plus the embedding, each camera's 1x1
    offset conv), laid out as the backward launches them, ``[N*B, 9*H*W]``
    k-major, and g ``[N*B, 9*H*W, C]`` f32 from ``rng`` (the module computes
    in f32 under --bf16 too), at DEFORM_CONV_SHAPE unless ``shape`` is given.
    ``bev_hw`` lays the samples out as a grid for the library call. Also
    returns the module and its input."""
    import torch

    from mvdetr_tpu_torch.models.world_feat import DeformConvWorldFeat
    from mvdetr_tpu_torch.ops.deform_conv import tap_coords

    b, n, h, w, c = ((shape or DEFORM_CONV_SHAPE)[k] for k in ("b", "n", "h", "w", "c"))
    mod = DeformConvWorldFeat(n, (h, w), c, c, generator=torch.Generator().manual_seed(0)).to(device)
    x = torch.from_numpy(rng.standard_normal((b, n, h, w, c), dtype=np.float32)).to(device)
    with torch.no_grad():
        off = mod.tap_offsets((x + mod.pos).movedim(1, 0))
    sx, sy = tap_coords(off.reshape(n * b, h, w, 9, 2), 3, 3, torch.float32)
    g = torch.from_numpy(rng.standard_normal((n * b, 9 * h * w, c), dtype=np.float32)).to(device)
    return {"g": g, "sx": sx.reshape(n * b, -1).contiguous(), "sy": sy.reshape(n * b, -1).contiguous(), "h": h,
            "w": w, "bev_hw": (9 * h, w), "module": mod, "x": x}


def deform_conv_phase(rng) -> dict:
    """B3 at the coordinates of deform_conv's input gradient at full width,
    f32: against its plain version with a bitwise repeat, timed, with its
    segments, its device time by stage and the library call; then the
    module's forward and forward + backward timed (one B3 launch each
    backward). Returns B3's record."""
    import torch

    from mvdetr_tpu_torch.ops.warp import warp_bwd

    c = deform_conv_warp_inputs(rng)
    seg = warp_segment_stats(c["sx"], c["sy"], c["h"], c["w"])
    print(f"B3 deform_conv segments: {seg['nonempty']} of {seg['cells']} cells get a tap, {seg['entries_inside']} of "
          f"{seg['entries']} entries inside; entries per non-empty cell mean {seg['mean']:.2f}, p90 {seg['p90']:.0f}, "
          f"p99 {seg['p99']:.0f}, largest {seg['max']}; mean distance of x to the nearest pixel centre "
          f"{float((c['sx'] - c['sx'].round()).abs().mean()):.3f}")
    rec = warp_case("deform_conv-f32", c["g"], c["sx"], c["sy"], c["h"], c["w"], bev_hw=c["bev_hw"], scaled=True)
    rec["segments"] = seg
    rec["device_ms"] = warp_stage_ms(lambda: warp_bwd(c["g"], c["sx"], c["sy"], c["h"], c["w"]))
    print("B3 deform_conv device time by stage: " + ", ".join(f"{k} {v:.4f} ms" for k, v in rec["device_ms"].items()))
    mod, x = c["module"], c["x"]
    del c
    torch.cuda.empty_cache()
    gy = torch.ones_like(x[:, 0])

    def fwd_bwd():
        xx = x.detach().requires_grad_()
        mod(xx)[0].backward(gy)

    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: mod(x), 3)
    before = warp_bwd.launches
    fwd_bwd()
    check(warp_bwd.launches == before + 1, f"deform_conv: {warp_bwd.launches - before} B3 launches in one backward")
    rec["module_ms"] = {"fwd_ms": fwd_ms, "fwd_bwd_ms": cuda_ms(fwd_bwd, 3)}
    print(f"deform_conv world feat at full width (7 cameras, 120x360, f32): forward {fwd_ms:.3f} ms, forward and "
          f"backward {rec['module_ms']['fwd_bwd_ms']:.3f} ms (B3 once a backward)")
    del mod, x, gy
    torch.cuda.empty_cache()
    return rec


def variants_card_vs_cpu() -> None:
    """Each ported variant at a small size, the card against the CPU from the
    same weights in f32 (TF32 off): the inference forward within
    SMALL_VARIANT_RTOL of scale, one train step's loss within it, every
    gradient at cosine >= 0.99 (0.8 where the card stages the attention value
    in bf16) and, outside the trunk, within 1e-2 relative L2 (0.4); then, with
    the library defaults, one step with remat on the card equal bit for bit to
    the same step without."""
    import torch

    from mvdetr_tpu_torch.geometry import make_synthetic_rig
    from mvdetr_tpu_torch.models import MVDeTr
    from mvdetr_tpu_torch.train import create_train_state, train_step

    saved = (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    rig = make_synthetic_rig(num_cam=3, img_shape=(96, 160), worldgrid_shape=(48, 96))
    batch = train_batch(rig, 2, world_reduce=2, img_reduce=12, seed=3)
    imgs, aff = torch.from_numpy(batch["imgs"]), torch.from_numpy(batch["affine_mats"])
    for config, tol in SMALL_VARIANT_RTOL.items():
        kw = FULL_WIDTH[config][0]
        exact = tol < SMALL_MODEL_RTOL
        cpu_model = MVDeTr.from_rig(rig, world_reduce=2, img_reduce=12, encoder_dropout=0.0, device="cpu", seed=1,
                                    **kw)
        perturb_attention(cpu_model, seed=2)
        card_model = copy.deepcopy(cpu_model).cuda()
        with torch.inference_mode():
            ref, out = cpu_model(imgs, aff)[0], card_model(imgs.cuda(), aff.cuda())[0]
        errs = [float((b.cpu() - a).abs().max()) / max(1.0, float(a.abs().max()))
                for a, b in zip((*ref[0], *ref[1]), (*out[0], *out[1]))]
        check(max(errs) <= tol, f"small {config}: card and CPU forwards differ by {max(errs)} of scale")
        auxes, grads = {}, {}
        for dev, model in (("cpu", cpu_model), ("cuda", card_model)):
            state = create_train_state(model, lr=LR, total_steps=TOTAL_STEPS)
            _, aux = train_step(state, batch, torch.Generator(device=dev).manual_seed(0), device=dev)
            auxes[dev] = float(aux["loss"])
            grads[dev] = {n: p.grad.detach().cpu().double() for n, p in model.named_parameters()}
        rel = abs(auxes["cuda"] - auxes["cpu"]) / abs(auxes["cpu"])
        worst_cos, worst_rel = 1.0, 0.0
        for n, a in grads["cpu"].items():
            b = grads["cuda"][n]
            cos = float((a * b).sum() / (a.norm() * b.norm()).clamp_min(1e-30))
            rel_l2 = float((a - b).norm() / a.norm().clamp_min(1e-30))
            worst_cos = min(worst_cos, cos)
            if not n.startswith("base."):
                worst_rel = max(worst_rel, rel_l2)
            check(cos >= (0.99 if exact else 0.8) and (n.startswith("base.") or rel_l2 <= (1e-2 if exact else 0.4)),
                  f"small {config} {n}: gradient cosine {cos}, relative L2 {rel_l2}")
        check(rel <= tol, f"small {config} train step: loss differs by {rel} relative")
        print(f"small {config} f32 card vs cpu: forward within {max(errs):.3e} of scale (bound {tol}); train step "
              f"loss cpu {auxes['cpu']:.6f}, card {auxes['cuda']:.6f} (relative {rel:.2e}), gradient cosine >= "
              f"{worst_cos:.5f}, relative L2 outside the trunk <= {worst_rel:.3e}")
        if config == "remat":
            remat_model = copy.deepcopy(cpu_model)
        del cpu_model, card_model
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = saved[0]
    torch.set_float32_matmul_precision(saved[1])

    # on the card, remat against the same step without it, with the library defaults (TF32 cuDNN convolutions), as
    # serving and training run: with TF32 off, two identical f32 steps already differ there (cuDNN takes backward
    # algorithms that are not deterministic), with or without remat
    steps = []
    for remat in (False, True):
        model = copy.deepcopy(remat_model).cuda()
        for m in model.modules():
            if hasattr(m, "remat"):
                m.remat = remat
        state = create_train_state(model, lr=LR, total_steps=TOTAL_STEPS)
        _, aux = train_step(state, batch, torch.Generator(device="cuda").manual_seed(0))
        steps.append((float(aux["loss"]), {n: p.grad for n, p in model.named_parameters()}, model.state_dict()))
    (l0, g0, s0), (l1, g1, s1) = steps
    differ = [n for n in g0 if not torch.equal(g0[n], g1[n])] + [k for k in s0 if not torch.equal(s0[k], s1[k])]
    print(f"small remat on the card: one step with remat equals the step without, bit for bit (loss, gradients, "
          f"parameters and BatchNorm statistics): {l0 == l1 and not differ}; differing leaves {differ[:6]}")
    check(l0 == l1 and not differ, "small remat: the step with remat differs from the step without on the card")


def lane_phase() -> dict:
    """B5: each variant against its plain version and the variants against
    each other at both sizes, then the experiment's entry point as the
    counted run. Returns a record per variant."""
    import torch

    from mvdetr_tpu_torch.ops import lane_broadcast as lb
    from mvdetr_tpu_torch.scripts import exp_vpu_broadcast as exp

    lk = lb.LM * lb.D
    recs = {name: {"by_T": {}} for name in lb.VARIANTS}
    for t in exp.SIZES:
        inputs = exp.make_inputs(t, "cuda")
        outs, scales = {}, {}
        for name in lb.VARIANTS:
            if name in lb.BROADCAST_VARIANTS:
                plain = lambda: lb.lane_broadcast_plain(inputs["x"], inputs["v"], name)  # noqa: E731
                nbytes, flops = t * (lb.LM * 4 + lk * 2 + lk * 4), lb.REPS * t * (2 * lk + lb.LM)
            else:
                plain = lambda: lb.lane_reduce_plain(inputs["dlk"], name)  # noqa: E731
                nbytes, flops = t * (lk * 4 + lb.LM * 4), lb.REPS * t * 2 * lk
            out, ref = exp.run(name, inputs), plain()
            torch.cuda.synchronize()
            err, scale = float((out - ref).abs().max()), float(ref.abs().max())
            check(bool(torch.isfinite(out).all()), f"B5 {name} T={t}: non-finite output")
            check(err <= LANE_RTOL * scale, f"B5 {name} T={t}: max abs error {err} > {LANE_RTOL} x {scale}")
            outs[name], scales[name] = out, scale
            rec = {"err": err, "plain_ms": cuda_ms(plain, 3), **bound(nbytes, flops)}
            recs[name]["by_T"][t] = rec
            print(f"B5 {name} T={t}: max_abs_err={err:.3e} (max |ref| {scale:.1f}), plain {rec['plain_ms']:.3f} ms, "
                  f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}, {nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP)")
        for a, b in (("matmul", "jnp_repeat"), ("matmul", "bcast3d"), ("r_matmul", "r_reshape_sum")):
            diff = float((outs[a] - outs[b]).abs().max())
            print(f"B5 T={t}: {a} vs {b} max abs difference {diff:.3e}")
            check(diff <= LANE_RTOL * scales[a], f"B5 T={t}: {a} and {b} disagree by {diff}")
        for other in ("matmul", "jnp_repeat", "bcast3d"):
            diff = float((outs["repeat"] - outs[other]).abs().max())
            print(f"B5 T={t}: repeat (the tile) vs {other} max abs difference {diff:.3e}")
            check(diff > LANE_RTOL * scales[other], f"B5 T={t}: repeat does not differ from {other}")
        x, v, dlk = inputs["x"], inputs["v"], inputs["dlk"]
        one_b = cuda_ms(lambda: x.view(t, lb.LM, 1) * v.view(t, lb.LM, lb.D), 20)
        one_r = cuda_ms(lambda: dlk.view(t, lb.LM, lb.D).sum(-1), 20)
        print(f"B5 T={t}: one PyTorch call per repetition, times {lb.REPS}: broadcast product "
              f"{one_b * lb.REPS:.4f} ms, head sum {one_r * lb.REPS:.4f} ms (context only: no single call computes "
              f"the {lb.REPS}-repetition function)")
        del inputs, outs, x, v, dlk
        torch.cuda.empty_cache()

    lb.lane_broadcast.launches.clear()
    lb.lane_reduce.launches.clear()
    times = exp.main()
    launches = {**lb.lane_broadcast.launches, **lb.lane_reduce.launches}
    for name in lb.VARIANTS:
        check(launches.get(name, 0) > 0, f"B5: the experiment launched {name} no time")
        recs[name]["launches"] = launches[name]
        for t in exp.SIZES:
            recs[name]["by_T"][t].update(times[(name, t)])
    return recs


def small_model_card_vs_cpu() -> None:
    import torch

    from mvdetr_tpu_torch.geometry import make_synthetic_rig
    from mvdetr_tpu_torch.models import MVDeTr
    from mvdetr_tpu_torch.train import create_train_state, train_step

    saved = (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())
    torch.backends.cudnn.allow_tf32 = False  # cuDNN's f32 default is TF32
    torch.set_float32_matmul_precision("highest")
    rig = make_synthetic_rig(num_cam=3, img_shape=(96, 160), worldgrid_shape=(48, 96))
    cpu_model = MVDeTr.from_rig(rig, world_reduce=2, img_reduce=12, encoder_dropout=0.0, device="cpu", seed=1)
    perturb_attention(cpu_model, seed=2)
    card_model = copy.deepcopy(cpu_model).cuda()
    batch = train_batch(rig, 2, world_reduce=2, img_reduce=12, seed=3)
    imgs, aff = torch.from_numpy(batch["imgs"]), torch.from_numpy(batch["affine_mats"])
    with torch.inference_mode():
        ref, ref_clips = cpu_model(imgs, aff)
        out, clips = card_model(imgs.cuda(), aff.cuda())
    names = ("world_heatmap", "world_offset", "imgs_heatmap", "imgs_offset", "imgs_wh")
    for name, a, b in zip(names, (*ref[0], *ref[1]), (*out[0], *out[1])):
        err = float((b.cpu() - a).abs().max())
        scale = float(a.abs().max())
        print(f"small model f32 card vs cpu {name}: max_abs_err={err:.3e} (max |ref| {scale:.3f})")
        check(err <= SMALL_MODEL_RTOL * max(1.0, scale), f"small model {name}: card and CPU disagree by {err}")
    # the clamp test |offset| > R flips for the few offsets the bf16 staging moves across R
    for i, (a, b) in enumerate(zip(ref_clips, clips)):
        print(f"small model layer {i} offset_clip_fraction: cpu {float(a):.5f}, card {float(b):.5f}")
        check(abs(float(a) - float(b)) <= 1e-2, "small model: offset_clip_fraction differs")

    # one train step from the same weights and batch (dropout 0)
    before = {n: p.detach().clone() for n, p in cpu_model.named_parameters()}
    auxes = {}
    for dev, model in (("cpu", cpu_model), ("cuda", card_model)):
        state = create_train_state(model, lr=LR, total_steps=TOTAL_STEPS)
        _, aux = train_step(state, batch, torch.Generator(device=dev).manual_seed(0), device=dev)
        auxes[dev] = {k: float(v) for k, v in aux.items()}
    rel = abs(auxes["cuda"]["loss"] - auxes["cpu"]["loss"]) / abs(auxes["cpu"]["loss"])
    print(f"small model f32 train step loss: cpu {auxes['cpu']['loss']:.6f}, card {auxes['cuda']['loss']:.6f} "
          f"(relative {rel:.2e})")
    check(rel <= 1e-2, f"small model train step: loss differs by {rel} relative")
    # Gradients through the trunk's BatchNorm backward amplify rounding at this
    # size (see tests/test_torch_port_train.py); the card's bf16-staged
    # attention value is such a rounding. Bounds as the bf16 CPU gate's.
    card = dict(card_model.named_parameters())
    worst_cos, worst_rel, worst_flip = 1.0, 0.0, 0.0
    lr0 = LR / 25.0
    for n, p in cpu_model.named_parameters():
        a, b = p.grad.double(), card[n].grad.cpu().double()
        cos = float((a * b).sum() / (a.norm() * b.norm()).clamp_min(1e-30))
        rel_l2 = float((a - b).norm() / a.norm().clamp_min(1e-30))
        lr = lr0 * (0.1 if n.startswith("base.") else 1.0)
        step_diff = ((card[n].detach().cpu() - before[n]) - (p.detach() - before[n])).abs()
        flip = float((step_diff > lr / 2).float().mean())
        worst_cos, worst_flip = min(worst_cos, cos), max(worst_flip, flip)
        if not n.startswith("base."):
            worst_rel = max(worst_rel, rel_l2)
        check(cos >= 0.8 and (n.startswith("base.") or rel_l2 <= 0.4), f"small model {n}: gradient cos {cos}, "
              f"relative L2 {rel_l2}")
        slack = 2 * lr + 4 * torch.finfo(torch.float32).eps * before[n].abs()  # Adam's step, each side rounded
        check(bool((step_diff <= slack).all()) and flip <= 0.25, f"small model {n}: updated parameters "
              f"differ (max {float(step_diff.max())}, {flip} of entries by more than lr/2)")
    stat_err = 0.0
    for n, t in cpu_model.state_dict().items():
        if n.endswith(("running_mean", "running_var")):
            ref_t = t.double()
            stat_err = max(stat_err, float((card_model.state_dict()[n].cpu().double() - ref_t).abs().max()
                                           / max(1.0, float(ref_t.abs().max()))))
    print(f"small model f32 train step, card vs cpu: gradient cosine >= {worst_cos:.4f}, relative L2 outside the "
          f"trunk <= {worst_rel:.3e}, updated parameters moving apart by more than lr/2 <= {worst_flip:.4f} of a "
          f"leaf, BatchNorm statistics within {stat_err:.2e} of scale")
    check(stat_err <= SMALL_MODEL_RTOL, f"small model train step: BatchNorm statistics differ by {stat_err}")
    torch.backends.cudnn.allow_tf32 = saved[0]  # serving and training run with the library defaults
    torch.set_float32_matmul_precision(saved[1])


def profile_table(label, fn, wall_ms, names):
    """Device time of one call of ``fn`` by kernel, from torch.profiler;
    ``names`` maps a label to the substrings of its device kernels' names.
    Returns the device time of each label."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = device_activities(prof)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    ours = {n: sum(e.self_device_time_total for e in kernels if any(k in e.key for k in keys)) / 1e3
            for n, keys in names.items()}
    print(f"{label} profile: {busy:.3f} ms of device activity ({busy / wall_ms:.3f} of the median wall time), of "
          f"which " + ", ".join(f"{n} {t:.3f} ms" for n, t in ours.items()) + "; top device activities:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:20]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  {e.key[:110]}")
    return ours


def serve_full_width(rig, config="flagship", n_timed=3):
    """Serve 1 + ``n_timed`` requests of a ``FULL_WIDTH`` configuration;
    every request must launch B1/B2/B3 as the table says. Returns the
    launches by kernel name, and the median request and peak memory."""
    import torch

    from mvdetr_tpu_torch.models import MVDeTr
    from mvdetr_tpu_torch.train import eval_step

    batch_size = 2
    kw, mode, per_request, _ = FULL_WIDTH[config]
    label = "serve" + FULL_WIDTH_LABELS[config]
    wrappers = main_path_launches()
    model = MVDeTr.from_rig(rig, world_reduce=4, img_reduce=12, compute_dtype=torch.bfloat16,
                            attn_radius=4, device="cuda", seed=0, **kw)
    perturb_attention(model, seed=1)
    check(getattr(model.world_feat, "mode", None) == mode, f"{label}: attention mode "
          f"{getattr(model.world_feat, 'mode', None)}, expected {mode}")
    rng = np.random.default_rng(0)
    batch = {"imgs": rng.integers(0, 256, (batch_size, 7, 720, 1280, 3), dtype=np.uint8),
             "affine_mats": np.tile(np.eye(3, dtype=np.float32), (batch_size, 7, 1, 1))}

    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers.values():
        fn.launches = 0
    latencies = []
    for _ in range(1 + n_timed):
        t0 = time.perf_counter()
        aux, xys, keep = eval_step(model, batch, world_reduce=4, num_candidates=512, nms_dist=20.0)
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
        check(tuple(xys.shape) == (batch_size, 512, 3) and tuple(keep.shape) == (batch_size, 512),
              f"{label}: shapes {tuple(xys.shape)}, {tuple(keep.shape)}")
        check(bool(torch.isfinite(xys).all()), f"{label}: non-finite detections")
        check(keep.dtype == torch.bool and int(keep.sum()) > 0, f"{label}: no detection kept")
    launches = {name: fn.launches for name, fn in wrappers.items()}
    expected = {name: k * (1 + n_timed) for name, k in zip(wrappers, per_request)}
    check(launches == expected, f"{label}: launches {launches} in {1 + n_timed} requests, expected {expected}")
    timed = latencies[1:]
    med = float(np.median(timed))
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{label}: warm-up {latencies[0]:.1f} ms, timed requests (ms) {[round(t, 3) for t in timed]}, "
          f"median {med:.3f} ms" + (f" (with F.interpolate: {INTERP_SERVE_MS} ms)" if config == "flagship" else "")
          + f", {batch_size / (med / 1e3):.3f} frame-sets/s, peak memory {peak:.2f} GiB")
    clip = f", offset_clip_fraction {float(aux['offset_clip_fraction']):.4f}" if "offset_clip_fraction" in aux else ""
    check(("offset_clip_fraction" in aux) == (mode in CLAMPED_MODES), f"{label}: offset_clip_fraction in "
          f"{sorted(aux)}")
    print(f"{label}: kept detections per frame set {keep.sum(1).tolist()}{clip}, launches {launches} in "
          f"{1 + n_timed} requests")
    profile_table(label, lambda: eval_step(model, batch, world_reduce=4, num_candidates=512, nms_dist=20.0),
                  med, {"msda_windowed_fwd": ("msda_windowed_fwd_kernel",), **GATHER_LABEL})
    return launches, {"median_ms": med, "peak_gib": peak}


def train_full_width(rig, batch, config="flagship", n_timed=5):
    """1 + ``n_timed`` train steps of a ``FULL_WIDTH`` configuration, each
    launching B1/B2/B3 as the table says (B3: the camera warp's, and in
    warped and gather modes one more per encoder layer), then the bitwise
    repeat of two steps. Returns the launch counts by kernel name, the
    step profile's device time by kernel label, and the median step and peak
    memory."""
    import torch

    from mvdetr_tpu_torch.models import MVDeTr
    from mvdetr_tpu_torch.train import batch_to_device, create_train_state, train_step

    batch_size = 2
    kw, mode, _, per_step = FULL_WIDTH[config]
    label = "train" + FULL_WIDTH_LABELS[config]
    wrappers = main_path_launches()
    model = MVDeTr.from_rig(rig, world_reduce=4, img_reduce=12, compute_dtype=torch.bfloat16, attn_radius=4,
                            device="cuda", seed=0, **kw)
    check(getattr(model.world_feat, "mode", None) == mode, f"{label}: attention mode "
          f"{getattr(model.world_feat, 'mode', None)}, expected {mode}")
    state = create_train_state(model, lr=LR, total_steps=TOTAL_STEPS)
    batch = batch_to_device(batch, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers.values():
        fn.launches = 0
    times, losses = [], []
    for _ in range(1 + n_timed):
        t0 = time.perf_counter()
        state, aux = train_step(state, batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(aux["loss"]))
        check(math.isfinite(losses[-1]), f"{label}: loss {losses[-1]} at step {state.step}")
    launches = {name: fn.launches for name, fn in wrappers.items()}
    steps = 1 + n_timed
    expected = {name: k * steps for name, k in zip(wrappers, per_step)}
    check(launches == expected, f"{label}: launches {launches} in {steps} steps, expected {expected}")
    timed = times[1:]
    med = float(np.median(timed))
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{label}: warm-up {times[0]:.1f} ms, timed steps (ms) {[round(t, 3) for t in timed]}, median {med:.3f} ms"
          + (f" (with F.interpolate: {INTERP_TRAIN_MS} ms)" if config == "flagship" else "")
          + f", {batch_size / (med / 1e3):.3f} frame-sets/s, peak memory {peak:.2f} GiB")
    check(("offset_clip_fraction" in aux) == (mode in CLAMPED_MODES), f"{label}: offset_clip_fraction in "
          f"{sorted(aux)}")
    print(f"{label}: losses {[round(v, 5) for v in losses]}, last step "
          + ", ".join(f"{k} {float(v):.4f}" for k, v in aux.items()) + f"; launches {launches} in {steps} steps")
    ours = profile_table(label, lambda: train_step(state, batch, gen), med,
                         {"msda_windowed_fwd": ("msda_windowed_fwd_kernel",), "msda_windowed_bwd": ("msda_bwd_",),
                          "warp_bwd": ("warp_bwd",),  # B3's four stages, CUB's sort kernels among them
                          **GATHER_LABEL})

    # two steps from the same state and generator, with PyTorch's default
    # algorithms (must be bitwise equal) and with deterministic ones (reported)
    snap = (copy.deepcopy(model.state_dict()), copy.deepcopy(state.optimizer.state_dict()),
            copy.deepcopy(state.scheduler.state_dict()), state.step, gen.get_state())
    runs = []
    for deterministic in (False, False, True, True):
        model.load_state_dict(snap[0])
        # load_state_dict keeps the optimizer state's tensors and the step updates them in place
        state.optimizer.load_state_dict(copy.deepcopy(snap[1]))
        state.scheduler.load_state_dict(snap[2])
        state.step = snap[3]
        gen.set_state(snap[4])
        torch.use_deterministic_algorithms(deterministic, warn_only=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            _, aux = train_step(state, batch, gen)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        torch.use_deterministic_algorithms(False)
        runs.append(({n: p.detach().clone() for n, p in model.named_parameters()},
                     {n: p.grad.clone() for n, p in model.named_parameters()}, float(aux["loss"]), ms,
                     sorted({str(w.message)[:160] for w in caught})))
    verdict = {}
    for kind, (a, b) in (("default algorithms", runs[:2]), ("deterministic algorithms", runs[2:])):
        differ = [n for n in a[0] if not torch.equal(a[0][n], b[0][n])]
        grads_differ = [n for n in a[1] if not torch.equal(a[1][n], b[1][n])]
        verdict[kind] = not differ and not grads_differ and a[2] == b[2]
        print(f"{label}, {kind}: two steps from the same state and generator give bitwise-equal parameters: "
              f"{not differ}; gradients: {not grads_differ}; losses equal: {a[2] == b[2]}; {len(differ)} of "
              f"{len(a[0])} parameter leaves and {len(grads_differ)} gradient leaves differ, the last in forward "
              f"order {grads_differ[::-1][:6]}; step {a[3]:.1f} and {b[3]:.1f} ms; warnings {a[4] + b[4]}")
    check(verdict["default algorithms"], f"{label}: two steps with PyTorch's default algorithms are not bitwise "
          "equal")
    return launches, ours, {"median_ms": med, "peak_gib": peak}


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def nccl_phase(rig, batch) -> dict:
    """The data-parallel train step on a one-rank NCCL group: this process
    joins ``torch.distributed`` alone (``tcp://localhost``), builds a mesh
    whose data axis is the one-rank world group, and the flagship model at full
    width with it and without it, from one seed. ``replicate_state``
    broadcasts the state; 1 + 3 sharded steps (the gradient all-reduce, the
    BatchNorm statistics' and the loss normalisers' all-reduces, the
    replication check, all through NCCL) run with every count set to 0
    just before and read just after (B1/B2/B3 3/3/1 a step), then as many
    plain steps from the same generator seed; every parameter, BatchNorm
    statistic and loss must be bitwise equal, and so must one sharded eval
    step's detections and the plain one's. Then ``Trainer`` with the mesh
    and without it, one epoch and a test of the CLI recipe's scene each: the
    same epoch loss and MODA. The group is destroyed before returning the
    launches and the step times."""
    import torch
    import torch.distributed as dist

    from mvdetr_tpu_torch.data import FrameDataset, SyntheticScene
    from mvdetr_tpu_torch.geometry import make_synthetic_rig
    from mvdetr_tpu_torch.models import MVDeTr
    from mvdetr_tpu_torch.parallel import Mesh
    from mvdetr_tpu_torch.parallel.sharding import make_sharded_eval_step, make_sharded_train_step, replicate_state
    from mvdetr_tpu_torch.train import Trainer, batch_to_device, create_train_state, eval_step, train_step

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", rank=0, world_size=1)
    try:
        # make_mesh gives a one-rank axis no group; here the data axis is bound to the one-rank world group so
        # that every collective of the data-parallel step runs through NCCL
        world = dist.group.WORLD
        mesh = Mesh({"data": 1, "view": 1, "bev": 1}, rank=0, coords={"data": 0, "view": 0, "bev": 0},
                    groups={"data": world}, world_group=world)
        check(dist.get_backend(mesh.group("data")) == "nccl", f"nccl: backend {dist.get_backend(mesh.group('data'))}")

        def build(m):
            model = MVDeTr.from_rig(rig, world_reduce=4, img_reduce=12, compute_dtype=torch.bfloat16, attn_radius=4,
                                    device="cuda", seed=0, mesh=m)
            return create_train_state(model, lr=LR, total_steps=TOTAL_STEPS)

        plain, sharded = build(None), build(mesh)
        replicate_state(sharded, mesh)
        grad_bytes = 4 * sum(p.numel() for p in sharded.model.parameters() if p.requires_grad)
        print(f"nccl: reduce_gradients sums {grad_bytes} bytes of f32 gradients a step: at N ranks each receives "
              f"(N - 1) x {grad_bytes} and holds N x {grad_bytes} bytes (a ring all-reduce: 2 (N - 1) / N x "
              f"{grad_bytes})")
        b = batch_to_device(batch, "cuda")
        step = make_sharded_train_step(mesh)
        wrappers = main_path_launches()
        steps = 4
        for fn in wrappers.values():
            fn.launches = 0
        gen = torch.Generator(device="cuda").manual_seed(0)
        times, losses = {"sharded": [], "plain": []}, {"sharded": [], "plain": []}
        for _ in range(steps):
            t0 = time.perf_counter()
            _, aux = step(sharded, b, gen, device="cuda")
            torch.cuda.synchronize()
            times["sharded"].append((time.perf_counter() - t0) * 1e3)
            losses["sharded"].append(float(aux["loss"]))
        launches = {name: fn.launches for name, fn in wrappers.items()}
        expected = {name: k * steps for name, k in zip(wrappers, FULL_WIDTH["flagship"][3])}
        print(f"nccl: {steps} sharded train steps on the one-rank group, launches {launches} (expected {expected})")
        check(launches == expected, f"nccl: launches {launches}, expected {expected}")
        gen = torch.Generator(device="cuda").manual_seed(0)
        for _ in range(steps):
            t0 = time.perf_counter()
            _, aux = train_step(plain, b, gen, device="cuda")
            torch.cuda.synchronize()
            times["plain"].append((time.perf_counter() - t0) * 1e3)
            losses["plain"].append(float(aux["loss"]))
        ours, ref = sharded.model.state_dict(), plain.model.state_dict()
        differ = [k for k in ref if not torch.equal(ours[k], ref[k])]
        med = {k: float(np.median(t[1:])) for k, t in times.items()}
        print(f"nccl: sharded vs plain after {steps} steps: {len(differ)} of {len(ref)} state entries differ "
              f"{differ[:4]}; losses {losses['sharded']} vs {losses['plain']}; median step {med['sharded']:.3f} ms "
              f"sharded, {med['plain']:.3f} ms plain (bf16, batch 2, full width; {torch.cuda.get_device_name(0)})")
        check(not differ and losses["sharded"] == losses["plain"], "nccl: the sharded step is not bitwise the plain one")
        serve = {"imgs": b["imgs"], "affine_mats": b["affine_mats"]}
        eval_sharded = make_sharded_eval_step(mesh)
        _, xys_s, keep_s = eval_sharded(sharded.model, serve, device="cuda")
        _, xys_p, keep_p = eval_step(plain.model, serve, device="cuda")
        check(torch.equal(xys_s, xys_p) and torch.equal(keep_s, keep_p), "nccl: sharded eval detections differ")
        del plain, sharded
        torch.cuda.empty_cache()

        # Trainer with the mesh and without it: one epoch and a test of the recipe's scene
        results = {}
        for label, m in (("mesh", mesh), ("plain", None)):
            small = make_synthetic_rig(num_cam=4, img_shape=(180, 320), worldgrid_shape=(120, 240))
            scene = SyntheticScene(small, num_frame=12, num_person=8, seed=2021)
            kw = dict(world_reduce=4, img_reduce=12, world_kernel_size=10, img_kernel_size=10, seed=2021)
            train_set = FrameDataset(scene, train=True, augmentation=True, **kw)
            test_set = FrameDataset(scene, train=False, **kw)
            model = MVDeTr.from_rig(small, world_reduce=4, img_reduce=12, device="cuda", seed=2021, mesh=m)
            state = create_train_state(model, lr=1e-3, total_steps=len(train_set))
            trainer = Trainer(state, train_set, test_set, cls_thres=0.4, logger=lambda *a: None, num_workers=4,
                              seed=2021, mesh=m)
            results[label] = (trainer.train_epoch(1, batch_size=2), trainer.test(batch_size=2))
        print(f"nccl: Trainer one epoch and test with the mesh {results['mesh']} and without {results['plain']}")
        check(results["mesh"] == results["plain"], "nccl: the Trainer on the mesh differs from the plain one")
    finally:
        dist.destroy_process_group()
    return {"launches": launches, "sharded_step_ms": med["sharded"], "plain_step_ms": med["plain"]}


# ----------------------------------------------------------------- the CLI and the Trainer
# the synthetic recipe of the repo's verify notes (SKILL.md, "The surface"), which reaches MODA >= 80 there
RECIPE = ["-d", "synthetic", "--epochs", "10", "--synthetic_frames", "12", "--augmentation", "true", "--world_feat",
          "deform_trans", "--lr", "1e-3", "--cls_thres", "0.4", "-j", "4", "--deterministic", "true"]
RECIPE_MODA = 80.0
VISUALIZE_RECIPE = RECIPE[:-2] + ["--epochs", "1", "--visualize"]  # without the determinism check
# the same recipe with the 8-point shadow reference maps (warped attention); its MODA gate is the JAX package's
# figure for --n_points 8 in its verify notes (SKILL.md)
RECIPE_SHADOW = RECIPE + ["--n_points", "8"]
# B1/B2's shape on the recipe's and the convergence rigs' path: 4 cameras, a 120x240 grid at world_reduce 4
# (30x60 BEV, 15x30 encoder grid), batch 1
RECIPE_ATTENTION = dict(b=1, l=4, h=15, w=30, m=8, d=16, p=4, radius=4)
# the 8-point shadow path: B1/B2 over the stack's L*P pseudo-levels of one point each, at the bench rig's shape
# (7 cameras x 8 points = 56) and the recipe's (4 x 8 = 32), offsets at integers drawn from the model's radial init
SHADOW_ATTENTION = dict(b=2, l=56, c=7, h=60, w=180, m=8, d=16, p=1, radius=4, init=(7, 8))
RECIPE_SHADOW_ATTENTION = dict(b=1, l=32, c=4, h=15, w=30, m=8, d=16, p=1, radius=4, init=(4, 8))
# the warp's forward gathers (the camera warp's and, in warped mode, the shadow warp's): index_select's kernel
GATHER_LABEL = {"index_select (warp gathers)": ("vectorized_gather_kernel", "indexSelect")}
# the configurations served and trained at full width: model keywords, the attention mode they resolve, and B1/B2/B3
# launches per request and per train step (B3: the camera warp's, and one per encoder layer in warped and gather modes)
# (the conv, trans and deform_conv fusions have no attention mode: B3 on the camera warp, and deform_conv's input
# gradient, all cameras in one call; VGG-11 and remat keep the flagship's fusion)
FULL_WIDTH = {
    "flagship": (dict(n_points=4), "windowed", (3, 0, 0), (3, 3, 1)),
    "shadow": (dict(n_points=8), "warped", (3, 0, 0), (3, 3, 4)),
    "gather": (dict(attn_mode="gather"), "gather", (0, 0, 0), (0, 0, 4)),
    "aio": (dict(world_feat_arch="aio"), "gather", (0, 0, 0), (0, 0, 4)),
    "conv": (dict(world_feat_arch="conv"), None, (0, 0, 0), (0, 0, 1)),
    "trans": (dict(world_feat_arch="trans"), None, (0, 0, 0), (0, 0, 1)),
    "deform_conv": (dict(world_feat_arch="deform_conv"), None, (0, 0, 0), (0, 0, 2)),
    "vgg11": (dict(arch="vgg11"), "windowed", (3, 0, 0), (3, 3, 1)),
    "remat": (dict(remat_backbone=True), "windowed", (3, 0, 0), (3, 3, 1)),
}
FULL_WIDTH_LABELS = {"flagship": "", "shadow": " n_points=8", "gather": " gather", "aio": " aio", "conv": " conv",
                     "trans": " trans", "deform_conv": " deform_conv", "vgg11": " vgg11", "remat": " remat"}
VARIANTS = ("conv", "trans", "deform_conv", "vgg11", "remat")
# the attention modes that clamp offsets and report the fraction clamped
CLAMPED_MODES = ("windowed", "warped")
# each variant through cli.main: SKILL.md's recipe for 2 epochs with the variant's flag (MODA printed, not gated)
VARIANT_RECIPE = ["-d", "synthetic", "--epochs", "2", "--synthetic_frames", "12", "--augmentation", "true", "--lr",
                  "1e-3", "--cls_thres", "0.4", "-j", "4", "--deterministic", "true"]
VARIANT_FLAGS = {"conv": ["--world_feat", "conv"], "trans": ["--world_feat", "trans"],
                 "deform_conv": ["--world_feat", "deform_conv"], "vgg11": ["--arch", "vgg11"],
                 "remat": ["--remat_backbone", "true"]}
# the variants at a small size, card against CPU in f32 (TF32 off): the forward's bound, of max(1, scale); the
# all-f32 fusions hold 1e-3, the windowed ones stage the attention value in bf16 on the card (SMALL_MODEL_RTOL)
SMALL_VARIANT_RTOL = {"conv": 1e-3, "trans": 1e-3, "deform_conv": 1e-3, "vgg11": SMALL_MODEL_RTOL,
                      "remat": SMALL_MODEL_RTOL}
# deform_conv at full width: the 7 cameras' 120x360 BEV maps of 128 channels, batch 2; its input gradient is one B3
# launch over the N*B maps of 9*H*W taps each
DEFORM_CONV_SHAPE = dict(b=2, n=7, h=120, w=360, c=128)
# gather attention at full width: the shadow transformer's encoder (7 camera levels of 60x180, every token a query)
# and the aio encoder's (one level, the 120x360 BEV); B3 takes the value's gradient as B*M*L maps of Q*P samples
GATHER_ATTENTION = dict(b=2, l=7, h=60, w=180, m=8, d=16, p=4)
AIO_ATTENTION = dict(b=2, l=1, h=120, w=360, m=8, d=16, p=4)
RECIPE_GATHER_ATTENTION = dict(b=1, l=4, h=15, w=30, m=8, d=16, p=4)
GATHER_ATOL = 1e-5  # f32 card vs CPU, of max(1, scale): sums of up to 4*L*P terms (B3: of a cell's taps) in another order
# gather vs B1/B2 in f32, of max(1, scale): tests/test_msda_windowed.py's bound on its 8x12 grid, and at the
# flagship's 60x180 grid a wider one: gather's x = (ref + off/W)*W - 0.5 carries up to ~W * 2^-23 ~ 2e-5 cells of f32
# rounding that windowed's x_q + off does not, and a sample moves by its slope (values of order 1) times that
GATHER_WINDOWED_ATOL = {"recipe": 2e-5, "flagship": 1e-4}
# (j) the reference-checkpoint path at the recipe's size (the CLI's synthetic defaults: 4 cameras, 180x320 frames,
# a 120x240 grid): the radial rings (4 cells at radius 4) scaled to 9.6 cells, so suggest_attn_radius picks 11 > 8,
# where the TPU path took its large-radius kernel B4
CKPT_RECIPE = ["-d", "synthetic", "--synthetic_frames", "12", "--cls_thres", "0.4", "-j", "4"]
CKPT_BIAS_SCALE, CKPT_RADIUS = 2.4, 11
# tests/test_convergence.py: its rigs, recipe and bounds
CONVERGENCE_RIGS = {
    "xy": dict(num_cam=4, img_shape=(180, 320), worldgrid_shape=(120, 240)),
    "ij": dict(num_cam=4, img_shape=(180, 320), worldgrid_shape=(120, 240), cell_meters=0.025, indexing="ij",
               worldcoord_unit=0.01, origin_offset=(-150.0, -450.0), name="SyntheticWildtrackBig"),
}
CONVERGENCE_MODA, CONVERGENCE_PRECISION, CONVERGENCE_LOSS_RATIO = 85.0, 90.0, 0.5
CONVERGENCE_EPOCHS = 10
# two epochs at Wildtrack width: 23 frames -> 20 train frame sets (10 steps of 2) and 3 test frame sets
WILDTRACK_CLI = ["-d", "synthetic", "--epochs", "2", "--synthetic_cams", "7", "--synthetic_img", "1080", "1920",
                 "--synthetic_grid", "480", "1440", "--synthetic_frames", "23", "--bf16", "true", "-b", "2",
                 "-j", "4"]
HOST_STAGES = ("render", "decode", "augment warp", "resize", "targets", "collate", "upload")
# (k) the hard benchmark's pinned recipe (scripts/hard_benchmark.py: seed 5, 15 epochs, 4 points) in windowed mode;
# its gate is the JAX package's worst-seed panel floor (the script's own --floor, 88, stays its exit rule)
HARD_BENCH_RUN = dict(seed=5, epochs=15, n_points=4, attn_mode="windowed", quiet=True)
HARD_BENCH_MODA = 85.0
# (l) a Wildtrack-format PNG tree at full width: 12 frames (10 train frame sets, 5 steps of 2; 2 test frame sets),
# then one epoch of the day-one command on it
DISK_FRAMES, DISK_PERSONS, DISK_WRITERS = 12, 20, 8
DISK_CLI = ["-d", "wildtrack", "--bf16", "true", "-b", "2", "-j", "4", "--epochs", "1"]
DAY_ONE_RADIUS = 8


class EpochProbe:
    """Instruments the CLI and the Trainer while installed, by replacing module
    attributes (put back by :meth:`uninstall`):

    - each ``train_step`` / ``eval_step`` call is counted and bracketed by two
      CUDA events on the current stream: the card's span of the step;
    - the host's thread-seconds by data stage: rendering
      (``SyntheticScene.image``, cached after a frame's first epoch), a
      dataset tree's decode (``adapters.load_image_rgb``), the
      augmentation warp and the resize (the native library), the targets,
      collation and the upload (pinning and queueing the copies);
    - ``Trainer.train_epoch`` and ``Trainer.test`` record, while
      ``self.epochs`` is a list, each call's wall time, frame sets, the sum of
      its steps' spans over its wall time (the card's busy share), peak
      memory and the stages per frame set, and the same rate and share after
      the fill: from the host's first step call (the first batch is ready
      and uploaded) to the call's end; every ``Trainer.test`` result is kept
      in ``self.tests``.
    """

    def __init__(self):
        self.lock = threading.Lock()
        self._saved = []
        self.train_steps = self.eval_steps = 0
        self.epochs = None
        self.tests = []
        self._begin_epoch()

    def _begin_epoch(self):
        self.stage_s = dict.fromkeys(HOST_STAGES, 0.0)
        self.spans = []
        self.items = 0
        self.first_step_t = None

    def _patch(self, owner, name, wrapper):
        self._saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, wrapper(getattr(owner, name)))

    def _timed(self, stage):
        def wrap(fn):
            def timed(*args, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kw)
                finally:
                    with self.lock:
                        self.stage_s[stage] += time.perf_counter() - t0
                        if stage == "collate":
                            self.items += len(args[0])
            return timed
        return wrap

    def _stepped(self, kind):
        def wrap(fn):
            def stepped(*args, **kw):
                import torch

                if self.first_step_t is None:
                    self.first_step_t = time.perf_counter()
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*args, **kw)
                end.record()
                self.spans.append((start, end))
                if kind == "train":
                    self.train_steps += 1
                else:
                    self.eval_steps += 1
                return out
            return stepped
        return wrap

    def _epoch(self, kind):
        def wrap(fn):
            def epoch(trainer, *args, **kw):
                import torch

                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                self._begin_epoch()
                t0 = time.perf_counter()
                out = fn(trainer, *args, **kw)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                wall = t1 - t0
                if kind == "test":
                    self.tests.append(out)
                if self.epochs is not None:
                    busy = sum(s.elapsed_time(e) for s, e in self.spans) / 1e3
                    n = max(self.items, 1)
                    after_fill = t1 - (self.first_step_t or t0)
                    self.epochs.append({
                        "kind": kind, "frame_sets": self.items, "steps": len(self.spans), "wall_s": wall,
                        "frame_sets_per_s": self.items / wall, "busy_share": busy / wall,
                        "fill_s": wall - after_fill, "after_fill_frame_sets_per_s": self.items / after_fill,
                        "after_fill_busy_share": busy / after_fill,
                        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                        "host_ms_per_frame_set": {k: v * 1e3 / n for k, v in self.stage_s.items()}})
                return out
            return epoch
        return wrap

    def install(self) -> "EpochProbe":
        from mvdetr_tpu_torch import native
        from mvdetr_tpu_torch.data import adapters, dataset, prefetch, source
        from mvdetr_tpu_torch.train import trainer

        self._patch(source.SyntheticScene, "image", self._timed("render"))
        self._patch(adapters, "load_image_rgb", self._timed("decode"))
        self._patch(native, "warp_image_u8", self._timed("augment warp"))
        self._patch(native, "resize_u8", self._timed("resize"))
        self._patch(dataset, "build_targets", self._timed("targets"))
        self._patch(dataset, "collate", self._timed("collate"))
        self._patch(prefetch, "upload", self._timed("upload"))
        self._patch(trainer, "train_step", self._stepped("train"))
        self._patch(trainer, "eval_step", self._stepped("eval"))
        self._patch(trainer.Trainer, "train_epoch", self._epoch("train"))
        self._patch(trainer.Trainer, "test", self._epoch("test"))
        return self

    def uninstall(self) -> None:
        for owner, name, orig in reversed(self._saved):
            setattr(owner, name, orig)
        self._saved.clear()


def main_path_launches() -> dict:
    from mvdetr_tpu_torch.ops.msda_windowed import msda_windowed_bwd, msda_windowed_fwd
    from mvdetr_tpu_torch.ops.warp import warp_bwd

    return {"msda_windowed_fwd": msda_windowed_fwd, "msda_windowed_bwd": msda_windowed_bwd, "warp_bwd": warp_bwd}


def counted_run(label, probe, fn, per_step=(3, 3, 1), per_eval=(3, 0, 0), trains=True):
    """Run ``fn`` with every kernel's count set to 0 just before and read
    just after: B1/B2/B3 must launch ``per_step`` times per train step and
    ``per_eval`` times per eval batch, each B5 variant no time; ``fn`` must
    take train steps when ``trains`` (else none) and eval batches. Returns
    ``(fn's result, launches by kernel)``, B5's under
    ``lane_broadcast:<variant>``."""
    from mvdetr_tpu_torch.ops import lane_broadcast as lb

    wrappers = main_path_launches()
    for w in wrappers.values():
        w.launches = 0
    lb.lane_broadcast.launches.clear()
    lb.lane_reduce.launches.clear()
    steps0, evals0 = probe.train_steps, probe.eval_steps
    out = fn()
    launches = {name: w.launches for name, w in wrappers.items()}
    b5 = lb.lane_broadcast.launches + lb.lane_reduce.launches
    launches.update({f"{lb.KERNEL_NAME}:{v}": b5[v] for v in lb.VARIANTS})
    steps, evals = probe.train_steps - steps0, probe.eval_steps - evals0
    expected = {name: a * steps + b * evals for name, a, b in zip(wrappers, per_step, per_eval)}
    expected.update({f"{lb.KERNEL_NAME}:{v}": 0 for v in lb.VARIANTS})
    print(f"{label}: {steps} train steps, {evals} eval batches; launches {launches} (expected {expected})")
    check((steps > 0) == trains and evals > 0 and launches == expected,
          f"{label}: {steps} train steps, {evals} eval batches, launches {launches}, expected {expected}")
    return out, launches


def visualize_phase(rig) -> dict:
    """The ``--visualize`` captures (``utils/visualize.py``): at a small size
    (3 cameras, f32, TF32 off) the card against the CPU from the same
    weights, in windowed (4 points), warped (8) and gather mode: every
    layer's sampling locations and attention weights and the three forward
    stages within SMALL_MODEL_RTOL of scale (the card stages the attention
    value in bf16); at full width (the flagship model, bf16, one frame set of
    the bench rig) both captures with every count set to 0 just before and
    read just after: B1 three times in each (one forward), B2 and B3 none,
    the shapes JAX's captures give and finite values; then the CLI recipe for
    one epoch with ``--visualize``, whose test writes the figures or, without
    matplotlib, says which it skipped. Returns the counted run's launches."""
    import torch

    from mvdetr_tpu_torch.geometry import make_synthetic_rig
    from mvdetr_tpu_torch.models import MVDeTr
    from mvdetr_tpu_torch.utils.visualize import capture_attention, capture_forward_stages

    saved = (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    small = make_synthetic_rig(num_cam=3, img_shape=(96, 160), worldgrid_shape=(48, 96))
    batch = train_batch(small, 1, world_reduce=2, img_reduce=12, seed=3)
    for mode, kw in (("windowed", {}), ("warped", dict(n_points=8)), ("gather", dict(attn_mode="gather"))):
        cpu_model = MVDeTr.from_rig(small, world_reduce=2, img_reduce=12, device="cpu", seed=1, **kw)
        perturb_attention(cpu_model, seed=2)
        card_model = copy.deepcopy(cpu_model).cuda()
        check(card_model.world_feat.mode == mode, f"visualize small: mode {card_model.world_feat.mode}")
        (_, ref), (_, out) = capture_attention(cpu_model, batch), capture_attention(card_model, batch)
        (_, ref_st), (_, out_st) = capture_forward_stages(cpu_model, batch), capture_forward_stages(card_model, batch)
        pairs = [(f"layer {i} {k}", a[k], c[k]) for i, (a, c) in enumerate(zip(ref, out)) for k in a]
        pairs += [(f"stage {k}", ref_st[k], out_st[k]) for k in ref_st]
        check(len(ref) == len(out) == 3 and ref_st.keys() == out_st.keys(), f"visualize small {mode}: structures")
        worst = 0.0
        for name, a, c in pairs:
            check(a.shape == c.shape, f"visualize small {mode} {name}: shapes {a.shape}, {c.shape}")
            err = float(np.abs(c - a).max()) / max(1.0, float(np.abs(a).max()))
            check(err <= SMALL_MODEL_RTOL, f"visualize small {mode} {name}: card and CPU differ by {err} of scale")
            worst = max(worst, err)
        print(f"visualize small {mode} f32 card vs cpu: capture_attention (3 layers, sampling locations "
              f"{tuple(out[0]['sampling_locations'].shape)}) and capture_forward_stages ({', '.join(out_st)}) within "
              f"{worst:.3e} of scale (bound {SMALL_MODEL_RTOL})")
        del cpu_model, card_model
    torch.backends.cudnn.allow_tf32 = saved[0]
    torch.set_float32_matmul_precision(saved[1])

    model = MVDeTr.from_rig(rig, world_reduce=4, img_reduce=12, compute_dtype=torch.bfloat16, attn_radius=4,
                            device="cuda", seed=0)
    perturb_attention(model, seed=1)
    full = train_batch(rig, 1, world_reduce=4, img_reduce=12, seed=2)
    wrappers = main_path_launches()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    _, layers = capture_attention(model, full)
    t1 = time.perf_counter()
    _, stages = capture_forward_stages(model, full)
    t2 = time.perf_counter()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    print(f"visualize full width (bf16, 1 frame set): capture_attention {(t1 - t0) * 1e3:.1f} ms, "
          f"capture_forward_stages {(t2 - t1) * 1e3:.1f} ms (host clock, copies to the host included); launches "
          f"{launches}")
    check(launches == dict(zip(wrappers, (6, 0, 0))), f"visualize full width: launches {launches}")
    n, (hs, ws) = rig.num_cam, (v // 2 for v in rig.Rworld_shape(4))
    check(len(layers) == 3, f"visualize full width: {len(layers)} layers")
    for layer in layers:
        check(layer["sampling_locations"].shape == (1, n * hs * ws, 8, n, 4, 2)
              and layer["attention_weights"].shape == (1, n * hs * ws, 8, n, 4), "visualize full width: shapes")
        check(all(np.isfinite(a).all() for a in layer.values()), "visualize full width: non-finite capture")
    h, w = rig.Rworld_shape(4)
    check(stages["world_inputs"].shape == (1, n, h, w, 128) and stages["world_feature"].shape == (1, h, w, 128)
          and stages["img_featmap"].shape[0] == n, "visualize full width: stage shapes")
    check(all(np.isfinite(a).all() for a in stages.values()), "visualize full width: non-finite stage")
    del model, layers, stages
    torch.cuda.empty_cache()

    _, log, figures = run_cli(VISUALIZE_RECIPE, figures=True)
    skipped = [line for line in log.splitlines() if "--visualize skipped" in line]
    print(f"visualize cli (the recipe for 1 epoch with --visualize): figures written {figures}; "
          f"{skipped[0] if skipped else 'none skipped'}")
    check(bool(figures) != bool(skipped), "visualize cli: neither figures nor the skip line")
    return launches


def run_cli(argv, trains=True, figures=False):
    """``cli.main(argv)`` on the card in a temporary logdir (removed after);
    the CLI's stdout tee and its cuDNN settings are put back. Returns
    the trainer and ``log.txt`` (and, with ``figures``, the names of the
    files in ``logdir/visualize``); a run that ``trains`` must leave a
    checkpoint."""
    import torch

    from mvdetr_tpu_torch import cli

    saved = (sys.stdout, torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    logdir = tempfile.mkdtemp(prefix="mvdetr_cli_")
    try:
        trainer = cli.main(argv + ["--logdir", logdir])
        with open(os.path.join(logdir, "log.txt")) as fh:
            log = fh.read()
        check(os.path.isfile(os.path.join(logdir, "test.txt")), "cli: no test.txt")
        check(not trains or bool(os.listdir(os.path.join(logdir, "checkpoints"))), "cli: no checkpoint")
        written = sorted(os.listdir(os.path.join(logdir, "visualize"))) if figures and os.path.isdir(
            os.path.join(logdir, "visualize")) else []
    finally:
        if sys.stdout is not saved[0]:
            sys.stdout.close()
            sys.stdout = saved[0]
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[1:]
        shutil.rmtree(logdir, ignore_errors=True)
    return (trainer, log, written) if figures else (trainer, log)


def recipe_phase(probe, argv=RECIPE, n_points=4) -> dict:
    """(a) SKILL.md's recipe through ``cli.main`` (at ``n_points`` 8 with
    ``argv=RECIPE_SHADOW``): the determinism check must pass and the last
    epoch's MODA reach RECIPE_MODA."""
    label = "cli recipe" if n_points == 4 else f"cli recipe n_points={n_points}"
    probe.tests = []
    t0 = time.perf_counter()
    (trainer, log), launches = counted_run(label, probe, lambda: run_cli(argv),
                                           per_step=FULL_WIDTH["flagship" if n_points == 4 else "shadow"][3])
    wall = time.perf_counter() - t0
    mode = trainer.state.model.world_feat.mode
    modas = [round(t[1], 1) for t in probe.tests]
    print(f"{label} ({' '.join(argv)}): {mode} attention, {wall:.1f} s; MODA by epoch {modas[:-1]}, then the "
          f"reloaded model {modas[-1]}; last epoch loss {probe.tests[-2][0]:.4f}, precision "
          f"{probe.tests[-2][3]:.1f}, recall {probe.tests[-2][4]:.1f}")
    check(mode == ("windowed" if n_points == 4 else "warped"), f"{label}: {mode} attention")
    check("determinism check passed" in log, f"{label}: the determinism check did not pass")
    check(len(probe.tests) == 11 and probe.tests[-1] == probe.tests[-2], f"{label}: tests do not repeat")
    check(probe.tests[-2][1] >= RECIPE_MODA, f"{label}: MODA {probe.tests[-2][1]} < {RECIPE_MODA}")
    return launches


def convergence_phase(probe) -> dict:
    """(b) tests/test_convergence.py through the port's Trainer on both rigs."""
    import torch

    from mvdetr_tpu_torch.data import FrameDataset, SyntheticScene
    from mvdetr_tpu_torch.geometry import make_synthetic_rig
    from mvdetr_tpu_torch.models import MVDeTr
    from mvdetr_tpu_torch.train import Trainer, create_train_state

    total = {}
    for name, rig_kw in CONVERGENCE_RIGS.items():
        def run():
            seed, epochs = 2021, CONVERGENCE_EPOCHS
            rig = make_synthetic_rig(**rig_kw)
            scene = SyntheticScene(rig, num_frame=12, num_person=8, seed=seed)
            kw = dict(world_reduce=4, img_reduce=12, top_k=32, world_kernel_size=10, img_kernel_size=10)
            train_set = FrameDataset(scene, train=True, augmentation=True, seed=seed, **kw)
            test_set = FrameDataset(scene, train=False, seed=seed, **kw)
            model = MVDeTr.from_rig(rig, world_reduce=4, img_reduce=12, world_feat_arch="deform_trans", seed=seed)
            state = create_train_state(model, lr=1e-3, total_steps=len(train_set) * epochs)
            trainer = Trainer(state, train_set, test_set, cls_thres=0.4, logger=lambda *a: None, seed=seed)
            losses = [trainer.train_epoch(ep, batch_size=1) for ep in range(1, epochs + 1)]
            return losses, trainer.test(batch_size=1)

        t0 = time.perf_counter()
        (losses, (_, moda, modp, precision, recall)), launches = counted_run(f"convergence {name}", probe, run)
        print(f"convergence {name} rig: {time.perf_counter() - t0:.1f} s; losses {[round(v, 4) for v in losses]}; "
              f"MODA {moda:.1f}, MODP {modp:.1f}, precision {precision:.1f}, recall {recall:.1f}")
        check(losses[-1] < CONVERGENCE_LOSS_RATIO * losses[0], f"convergence {name}: loss {losses[0]} -> {losses[-1]}")
        check(moda >= CONVERGENCE_MODA, f"convergence {name}: MODA {moda} < {CONVERGENCE_MODA}")
        check(precision >= CONVERGENCE_PRECISION, f"convergence {name}: precision {precision}")
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
        torch.cuda.empty_cache()
    return total


def wildtrack_cli_phase(probe) -> dict:
    """(c) two epochs at Wildtrack width through ``cli.main``: per epoch the
    train and test frame-sets/s, the card's busy share, peak memory and the
    host's time per frame set by stage."""
    import torch

    probe.epochs, probe.tests = [], []
    try:
        (trainer, log), launches = counted_run("cli wildtrack", probe, lambda: run_cli(WILDTRACK_CLI))
    finally:
        epochs, probe.epochs = probe.epochs, None
    labels = iter(["epoch 1 train", "epoch 1 test", "epoch 2 train", "epoch 2 test", "final test"])
    for rec, label in zip(epochs, labels):
        stages = ", ".join(f"{k} {v:.2f}" for k, v in rec["host_ms_per_frame_set"].items())
        print(f"cli wildtrack {label}: {rec['frame_sets']} frame sets, {rec['steps']} steps in {rec['wall_s']:.3f} s, "
              f"{rec['frame_sets_per_s']:.3f} frame-sets/s, card busy share {rec['busy_share']:.3f}; after the "
              f"{rec['fill_s']:.3f} s fill (to the first step) {rec['after_fill_frame_sets_per_s']:.3f} frame-sets/s, "
              f"busy share {rec['after_fill_busy_share']:.3f}; peak memory {rec['peak_gib']:.2f} GiB; host ms per "
              f"frame set (thread time): {stages}")
        check(rec["frame_sets"] > 0 and math.isfinite(rec["frame_sets_per_s"]), f"cli wildtrack {label}: no work")
    check(len(epochs) == 5, f"cli wildtrack: {len(epochs)} epoch records")
    check(all(math.isfinite(t[0]) for t in probe.tests), "cli wildtrack: non-finite test loss")
    print(f"cli wildtrack: MODA by epoch {[round(t[1], 1) for t in probe.tests]} (random init, 2 epochs: no bound); "
          f"{torch.cuda.get_device_name(0)}")
    return {"launches": launches, "epochs": epochs}


def checkpoint_phase(probe) -> dict:
    """(j) ``--load_torch_ckpt`` through ``cli.main`` at the recipe's size.
    Nothing can be downloaded, so the ``MultiviewDetector.pth`` is a seeded
    port model with its offset biases scaled by CKPT_BIAS_SCALE and its
    offset kernels left at zero, saved as ``{"state_dict": {"module." + k:
    v}}``. Evaluated in gather mode (no kernel launch), then at the
    defaults (the radius picked from the biases, B1 three times per eval
    batch, no clamp binding); a wrong ``--n_points`` must exit with the
    flag to pass. Both evaluations print a MODA line, and the two loaded
    models' BEV heatmaps agree: on the CPU in f32 within 1e-4 of scale (the
    same function: every offset inside the radius), on the card within
    SMALL_MODEL_RTOL (windowed mode stages the value in bf16 there).
    Returns the launches by run and the picked radius."""
    import torch

    from mvdetr_tpu_torch.geometry import make_synthetic_rig
    from mvdetr_tpu_torch.models import MVDeTr

    rig = make_synthetic_rig(num_cam=4, img_shape=(180, 320), worldgrid_shape=(120, 240))  # the CLI's defaults
    model = MVDeTr.from_rig(rig, world_reduce=4, img_reduce=12, device="cpu", seed=5)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("sampling_offsets.bias"):
                p.mul_(CKPT_BIAS_SCALE)
    tmp = tempfile.mkdtemp(prefix="mvdetr_ckpt_")
    try:
        path = os.path.join(tmp, "MultiviewDetector.pth")
        torch.save({"state_dict": {f"module.{k}": v for k, v in model.state_dict().items()}}, path)
        argv = CKPT_RECIPE + ["--load_torch_ckpt", path]
        runs, launches = {}, {}
        for mode, per_eval in (("gather", (0, 0, 0)), ("auto", (3, 0, 0))):
            probe.tests = []
            t0 = time.perf_counter()
            runs[mode], launches[mode] = counted_run(
                f"checkpoint {mode}", probe, lambda: run_cli(argv + ["--attn_mode", mode], trains=False),
                per_eval=per_eval, trains=False)
            trainer, log = runs[mode]
            moda = [line for line in log.splitlines() if line.startswith("Test: loss")]
            print(f"checkpoint {mode}: {trainer.state.model.world_feat.mode} attention, "
                  f"{time.perf_counter() - t0:.1f} s; {moda[-1] if moda else 'no test line'}")
            check(len(moda) == 1 and "moda" in moda[0] and trainer.state.step == 0, f"checkpoint {mode}: {moda}")
            check(trainer.state.model.warp_convention == "kornia", f"checkpoint {mode}: not the kornia warp")
        gather_model, auto_model = runs["gather"][0].state.model, runs["auto"][0].state.model
        radius_line = [line for line in runs["auto"][1].splitlines() if line.startswith("auto attn_radius")]
        print(f"checkpoint auto: {radius_line}; "
              f"{[ln for ln in runs['auto'][1].splitlines() if ln.startswith('Eval offset_clip_fraction')]}")
        radius = auto_model.world_feat.encoder.layers[0].self_attn.radius
        check(gather_model.world_feat.mode == "gather" and auto_model.world_feat.mode == "windowed",
              "checkpoint: attention modes")
        check(radius == CKPT_RADIUS and len(radius_line) == 1 and radius_line[0].startswith(
            f"auto attn_radius {CKPT_RADIUS} "), f"checkpoint auto: radius {radius}, {radius_line}")
        check("Eval offset_clip_fraction 0.0000" in runs["auto"][1], "checkpoint auto: a clamp binds")
        try:
            run_cli(argv + ["--n_points", "8"], trains=False)
            check(False, "checkpoint: a wrong --n_points did not exit")
        except SystemExit as e:
            print(f"checkpoint with --n_points 8: SystemExit({str(e)!r})")
            check(str(e).endswith("rerun with: --n_points 4"), f"checkpoint: exit message {e}")

        batch = train_batch(rig, 2, world_reduce=4, img_reduce=12, seed=1, num_person=8)
        imgs, aff = torch.from_numpy(batch["imgs"]), torch.from_numpy(batch["affine_mats"])
        heat = {}
        for where in ("cuda", "cpu"):
            for mode, m in (("gather", gather_model), ("auto", auto_model)):
                with torch.inference_mode():
                    heat[where, mode] = m.to(where)(imgs.to(where), aff.to(where))[0][0][0].float().cpu()
        for where, tol in (("cpu", 1e-4), ("cuda", SMALL_MODEL_RTOL)):
            err, scale = float((heat[where, "gather"] - heat[where, "auto"]).abs().max()), float(
                heat[where, "gather"].abs().max())
            print(f"checkpoint BEV heatmaps, gather vs auto (windowed, R={radius}) on the {where}: max_abs_err "
                  f"{err:.3e} (max |ref| {scale:.3f}, bound {tol} of scale)")
            check(err <= tol * max(1.0, scale), f"checkpoint: gather and auto heatmaps differ by {err} on {where}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"launches": launches, "radius": radius}


def variant_cli_phase(probe) -> dict:
    """(e) each ported variant's flag through ``cli.main``: VARIANT_RECIPE (2
    epochs of SKILL.md's recipe, ``--deterministic true``) with the flag; the
    determinism check must pass, each train step and eval batch must launch
    B1/B2/B3 as FULL_WIDTH says; MODA is printed, not gated. Returns the
    launches by variant."""
    launches = {}
    for config, flags in VARIANT_FLAGS.items():
        probe.tests = []
        t0 = time.perf_counter()
        _, per_eval, per_step = FULL_WIDTH[config][1:]
        (trainer, log), launches[config] = counted_run(f"cli {config}", probe, lambda: run_cli(VARIANT_RECIPE + flags),
                                                       per_step=per_step, per_eval=per_eval)
        check("determinism check passed" in log, f"cli {config}: the determinism check did not pass")
        modas = [round(t[1], 1) for t in probe.tests]
        print(f"cli {config} ({' '.join(flags)}): {time.perf_counter() - t0:.1f} s; MODA by epoch {modas[:-1]}, then "
              f"the reloaded model {modas[-1]} (2 epochs: recorded, not gated); last epoch loss "
              f"{probe.tests[-2][0]:.4f}")
    return launches


def hard_benchmark_phase(probe) -> dict:
    """(k) the hard benchmark's pinned recipe on the card through its twin's
    ``run()`` (``mvdetr_tpu_torch/scripts/hard_benchmark.py``: 6 cameras at
    3.5 m, 270x480 frames, a 256x512 grid, 24 people, seed 5, 15 epochs,
    windowed at 4 points): the final MODA must reach HARD_BENCH_MODA."""
    from mvdetr_tpu_torch.scripts import hard_benchmark

    probe.tests = []
    result, launches = counted_run("hard benchmark", probe, lambda: hard_benchmark.run(**HARD_BENCH_RUN))
    print(f"hard benchmark (seed {HARD_BENCH_RUN['seed']}, {HARD_BENCH_RUN['epochs']} epochs, windowed): FINAL MODA "
          f"{result['moda']:.1f}, MODP {result['modp']:.1f}, precision {result['precision']:.1f}, recall "
          f"{result['recall']:.1f}; {result['seconds']:.1f} s of training and tests; MODA at the tests "
          f"{[round(t[1], 1) for t in probe.tests]}")
    check(result["moda"] >= HARD_BENCH_MODA, f"hard benchmark: MODA {result['moda']} < {HARD_BENCH_MODA}")
    return launches


def write_disk_tree(root: str):
    """A Wildtrack-format tree of DISK_FRAMES frames (``data/trees.py``): the
    calibrations and annotations, then every frame as a PNG written by
    DISK_WRITERS threads (zlib releases the interpreter lock). Returns the
    scene (its renders cached) and the write's seconds and bytes."""
    from mvdetr_tpu_torch.data.png import write_png
    from mvdetr_tpu_torch.data.trees import image_path, wildtrack_like_scene, write_wildtrack_tree

    t0 = time.perf_counter()
    scene = wildtrack_like_scene(num_frame=DISK_FRAMES, num_person=DISK_PERSONS)
    write_wildtrack_tree(root, scene, with_images=False)
    keys = [(cam, frame) for frame in scene.frames() for cam in range(scene.rig.num_cam)]
    for cam in range(scene.rig.num_cam):
        os.makedirs(os.path.dirname(image_path(root, cam, 0)), exist_ok=True)
    with ThreadPoolExecutor(DISK_WRITERS) as pool:
        list(pool.map(lambda key: write_png(image_path(root, *key), scene.image(*key)), keys))
    nbytes = sum(os.path.getsize(image_path(root, *key)) for key in keys)
    return scene, time.perf_counter() - t0, nbytes


def disk_phase(probe, root: str) -> dict:
    """(l) the disk path at full width: a Wildtrack-format PNG tree of
    DISK_FRAMES frames of 1080x1920 (``write_disk_tree``), every frame
    decoded by ``data/png.py`` bitwise equal to the scene's own render, then
    one epoch of ``cli.main(["-d", "wildtrack", "--data_root", root, ...])``
    (bf16, batch 2, 4 loader threads): the train and test frame-sets/s, the
    card's busy share and the decode's thread-ms per frame."""
    from mvdetr_tpu_torch.data.png import decode_png
    from mvdetr_tpu_torch.data.trees import image_path

    scene, write_s, nbytes = write_disk_tree(root)
    keys = [(cam, frame) for frame in scene.frames() for cam in range(scene.rig.num_cam)]
    t0 = time.perf_counter()
    bad = [key for key in keys if not np.array_equal(decode_png(image_path(root, *key)), scene.image(*key))]
    decode_s = time.perf_counter() - t0
    print(f"disk tree: {len(keys)} 1080x1920 PNGs, {nbytes / 1e6:.1f} MB ({nbytes / len(keys) / 1e6:.2f} MB each), "
          f"written in {write_s:.1f} s by {DISK_WRITERS} threads; decoded in {decode_s * 1e3 / len(keys):.1f} ms "
          f"each (one thread), {len(keys) - len(bad)} of {len(keys)} bitwise the scene's renders")
    check(not bad, f"disk tree: decoded frames differ from the renders at (camera, frame) {bad[:5]}")

    probe.epochs, probe.tests = [], []
    try:
        (trainer, _), launches = counted_run("cli disk", probe, lambda: run_cli(DISK_CLI + ["--data_root", root]))
    finally:
        epochs, probe.epochs = probe.epochs, None
    num_cam = trainer.train_set.rig.num_cam
    for rec, label in zip(epochs, ("epoch 1 train", "epoch 1 test", "final test")):
        stages = ", ".join(f"{k} {v:.2f}" for k, v in rec["host_ms_per_frame_set"].items())
        print(f"cli disk {label}: {rec['frame_sets']} frame sets, {rec['steps']} steps in {rec['wall_s']:.3f} s, "
              f"{rec['frame_sets_per_s']:.3f} frame-sets/s, card busy share {rec['busy_share']:.3f}; after the "
              f"{rec['fill_s']:.3f} s fill {rec['after_fill_frame_sets_per_s']:.3f} frame-sets/s, busy share "
              f"{rec['after_fill_busy_share']:.3f}; peak memory {rec['peak_gib']:.2f} GiB; decode "
              f"{rec['host_ms_per_frame_set']['decode'] / num_cam:.2f} thread-ms per frame; host ms per frame set "
              f"(thread time): {stages}")
        check(rec["frame_sets"] > 0 and rec["host_ms_per_frame_set"]["decode"] > 0, f"cli disk {label}: no decode")
    check(len(epochs) == 3 and all(math.isfinite(t[0]) for t in probe.tests), f"cli disk: {len(epochs)} records, "
          f"tests {probe.tests}")
    print(f"cli disk: MODA {[round(t[1], 1) for t in probe.tests]} (random init, 1 epoch: no bound)")
    return launches


def day_one_phase(probe, root: str) -> dict:
    """(m) the day-one rehearsal on (l)'s tree, as
    ``mvdetr_tpu_torch/scripts/rehearse_day_one.py`` runs it: a seeded port
    model at the full flagship configuration saved as a reference
    ``MultiviewDetector.pth``, evaluated by ``cli.main`` with
    ``--load_torch_ckpt`` in windowed mode at radius DAY_ONE_RADIUS, batch 1:
    B1 three times per eval batch and no clamp binding; its MODA line is
    printed (random weights: no bound)."""
    from mvdetr_tpu_torch.data import WildtrackScene
    from mvdetr_tpu_torch.scripts import rehearse_day_one

    tmp = tempfile.mkdtemp(prefix="mvdetr_day_one_")
    try:
        t0 = time.perf_counter()
        ckpt = os.path.join(tmp, "MultiviewDetector.pth")
        size_mib = rehearse_day_one.save_reference_checkpoint(ckpt, WildtrackScene(root).rig)
        save_s = time.perf_counter() - t0
        probe.tests = []
        t0 = time.perf_counter()
        argv = rehearse_day_one.day_one_argv(root, ckpt, "windowed", DAY_ONE_RADIUS)
        (trainer, log), launches = counted_run("day one", probe, lambda: run_cli(argv, trains=False),
                                               per_eval=(3, 0, 0), trains=False)
        eval_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    model = trainer.state.model
    radius = model.world_feat.encoder.layers[0].self_attn.radius
    moda = [line for line in log.splitlines() if line.startswith("Test: loss")]
    clip = [line for line in log.splitlines() if line.startswith("Eval offset_clip_fraction")]
    print(f"day one: checkpoint {size_mib:.1f} MiB saved in {save_s:.1f} s; evaluated in {eval_s:.1f} s "
          f"({model.world_feat.mode} attention, R={radius}, {model.warp_convention} warp); {clip}; "
          f"{moda[-1] if moda else 'no test line'}")
    check(model.world_feat.mode == "windowed" and radius == DAY_ONE_RADIUS,
          f"day one: {model.world_feat.mode}, R={radius}")
    check(model.warp_convention == "kornia" and trainer.state.step == 0, "day one: not the checkpoint's evaluation")
    check(len(moda) == 1 and clip == ["Eval offset_clip_fraction 0.0000"], f"day one: {moda}, {clip}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from mvdetr_tpu_torch import native
    from mvdetr_tpu_torch.ops import kernel_build, lane_broadcast, msda_windowed, warp

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    names = (msda_windowed.KERNEL_NAME, msda_windowed.BWD_KERNEL_NAME, warp.KERNEL_NAME, lane_broadcast.KERNEL_NAME)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        libs = list(pool.map(kernel_build.build, names))
    msda_windowed.load_library()
    msda_windowed.load_bwd_library()
    warp.load_library()
    lane_broadcast.load_library()
    print(f"build: {', '.join(names)} in {time.perf_counter() - t0:.1f} s (in parallel)")
    t0 = time.perf_counter()
    native.load_library()  # the data path's host library (g++), built at first use as the kernels are
    print(f"build: native/dataio.cpp in {time.perf_counter() - t0:.1f} s -> "
          f"{os.path.relpath(native.library_path(), ROOT)}")
    for name, lib in zip(names, libs):
        print(f"build log {name} -> {os.path.relpath(lib, ROOT)}:\n{(lib.parent / 'build.log').read_text().strip()}")

    rng = np.random.default_rng(0)
    flagship = dict(b=2, l=7, h=60, w=180, m=8, d=16, p=4, radius=4)
    narrow = dict(b=1, l=3, h=60, w=180, m=2, d=16, p=4)
    # ragged grid (no multiple of any tile), other head widths, more cameras than levels
    edge_cases = {"narrow-37x101": dict(narrow, h=37, w=101), "narrow-D8": dict(narrow, d=8),
                  "narrow-D32": dict(narrow, d=32), "narrow-D5": dict(narrow, d=5), "narrow-C5": dict(narrow, c=5)}
    b1 = fwd_case("flagship-random", **flagship, integer=False, rng=rng, timed=True)
    b1_int = fwd_case("flagship-integer", **flagship, integer=True, rng=rng, timed=True)
    b1_errs = [b1["err"], b1_int["err"]]
    for radius in (0, 1, 8, 12, 16):
        b1_errs.append(fwd_case(f"narrow-R{radius}", **narrow, radius=radius, integer=False, rng=rng,
                                timed=False)["err"])
    for name, shape in edge_cases.items():
        b1_errs.append(fwd_case(name, **shape, radius=4, integer=False, rng=rng, timed=False)["err"])
    # B4 (the TPU's variant for radius > 8) is B1's kernel at that radius: timed at the flagship shape
    b1_r16 = fwd_case("flagship-R16", **{**flagship, "radius": 16}, integer=False, rng=rng, timed=True)
    b1_errs.append(b1_r16["err"])
    b1.update({"ms_integer": b1_int["ms"], "ms_R16": b1_r16["ms"]})

    b2 = bwd_case("flagship-random", **flagship, integer=False, rng=rng, timed=True)
    b2_int = bwd_case("flagship-integer", **flagship, integer=True, rng=rng, timed=True)
    b2.update({"ms_integer": b2_int["ms"], "value_ms_integer": b2_int["value_ms"],
               "query_ms_integer": b2_int["query_ms"]})
    b2_errs = [b2["err"], b2_int["err"]]
    for radius in (0, 1, 8, 12, 16):
        b2_errs.append(bwd_case(f"narrow-R{radius}", **narrow, radius=radius, integer=False, rng=rng,
                                timed=False)["err"])
    for name, shape in edge_cases.items():
        b2_errs.append(bwd_case(name, **shape, radius=4, integer=False, rng=rng, timed=False)["err"])
    b2_r16 = bwd_case("flagship-R16", **{**flagship, "radius": 16}, integer=False, rng=rng, timed="query")
    b2_errs.append(b2_r16["err"])
    b2["query_ms_R16"] = b2_r16["query_ms"]
    # the shape the cli recipe and the convergence rigs launch B1 and B2 at
    for integer in (False, True):
        label = f"recipe-{'integer' if integer else 'random'}"
        b1_errs.append(fwd_case(label, **RECIPE_ATTENTION, integer=integer, rng=rng, timed=False)["err"])
        b2_errs.append(bwd_case(label, **RECIPE_ATTENTION, integer=integer, rng=rng, timed=False)["err"])
    halo = row_halo_phase(rng)
    view = view_phase(rng)

    rig = bench_rig()
    batch = train_batch(rig, 2, world_reduce=4, img_reduce=12, seed=0)
    b3 = warp_phase(rng, rig, batch)
    shadow = shadow_kernel_phase(rng, rig)
    gather = gather_kernel_phase(rng)
    deform = deform_conv_phase(rng)
    b5 = lane_phase()

    small_model_card_vs_cpu()
    variants_card_vs_cpu()
    serve_launches, serve_stats = serve_full_width(rig)
    torch.cuda.empty_cache()
    train_launches, step_profile, train_stats = train_full_width(rig, batch)
    warp_profile(b3, rig, batch, step_profile[warp.KERNEL_NAME])
    torch.cuda.empty_cache()
    # the 8-point shadow configuration at the same width: warped attention, B3 also on each layer's shadow warp
    shadow_serve_launches, _ = serve_full_width(rig, "shadow")
    torch.cuda.empty_cache()
    shadow_train_launches, _, _ = train_full_width(rig, batch, "shadow")
    torch.cuda.empty_cache()
    # (h) gather attention and (i) aio at the same width: B3 on the camera warp and each encoder layer's value
    gather_launches = {"serve": serve_full_width(rig, "gather")[0]}
    torch.cuda.empty_cache()
    gather_launches["train"] = train_full_width(rig, batch, "gather")[0]
    torch.cuda.empty_cache()
    aio_launches = {"serve": serve_full_width(rig, "aio", n_timed=1)[0]}
    torch.cuda.empty_cache()
    aio_launches["train"] = train_full_width(rig, batch, "aio", n_timed=3)[0]
    torch.cuda.empty_cache()
    # the other fusions, VGG-11 and remat at the same width
    variant_launches, variant_stats = {}, {"flagship": {"request": serve_stats, "step": train_stats}}
    for config in VARIANTS:
        serve_l, serve_s = serve_full_width(rig, config, n_timed=2)
        torch.cuda.empty_cache()
        train_l, _, train_s = train_full_width(rig, batch, config, n_timed=3)
        torch.cuda.empty_cache()
        variant_launches[config] = {"serve": serve_l, "train": train_l}
        variant_stats[config] = {"request": serve_s, "step": train_s}
    # the data-parallel step on a one-rank NCCL group, bitwise the plain step
    nccl = nccl_phase(rig, batch)
    torch.cuda.empty_cache()
    # the --visualize captures and figures
    visualize_launches = visualize_phase(rig)
    torch.cuda.empty_cache()

    probe = EpochProbe().install()
    try:
        recipe_launches = recipe_phase(probe)
        shadow_recipe_launches = recipe_phase(probe, RECIPE_SHADOW, n_points=8)
        trainer_launches = convergence_phase(probe)
        wildtrack = wildtrack_cli_phase(probe)
        ckpt = checkpoint_phase(probe)
        for config, launches in variant_cli_phase(probe).items():
            variant_launches[config]["cli"] = launches
        script_launches = {"hard_benchmark": hard_benchmark_phase(probe)}
        torch.cuda.empty_cache()
        tree = tempfile.mkdtemp(prefix="mvdetr_tree_")
        try:
            root = os.path.join(tree, "Wildtrack")
            script_launches["disk"] = disk_phase(probe, root)
            torch.cuda.empty_cache()
            script_launches["day_one"] = day_one_phase(probe, root)
        finally:
            shutil.rmtree(tree, ignore_errors=True)
    finally:
        probe.uninstall()
    print("full-width medians and peaks (bf16, batch 2; " + torch.cuda.get_device_name(0) + "): " + "; ".join(
        f"{config}: request {st['request']['median_ms']:.3f} ms ({st['request']['peak_gib']:.2f} GiB), step "
        f"{st['step']['median_ms']:.3f} ms ({st['step']['peak_gib']:.2f} GiB)" for config, st in variant_stats.items()))
    cli_launches = {k: recipe_launches[k] + wildtrack["launches"][k] for k in recipe_launches}
    shadow_by_path = {name: {"serve": shadow_serve_launches[name], "train": shadow_train_launches[name],
                             "cli": shadow_recipe_launches[name]} for name in shadow_serve_launches}
    print(f"shadow path launches by kernel and path: {shadow_by_path}")
    for name, by_path in shadow_by_path.items():
        check(sum(by_path.values()) > 0, f"shadow path: {name} launched no time")
    print(f"variant launches by path: {variant_launches}")

    records = [
        (msda_windowed.KERNEL_NAME, "mvdetr_tpu/ops/pallas/msda_kernel.py:95", b1, b1_errs + shadow["b1"]["errs"],
         {"serve": serve_launches[msda_windowed.KERNEL_NAME], "train": train_launches[msda_windowed.KERNEL_NAME],
          "cli": cli_launches[msda_windowed.KERNEL_NAME], "trainer": trainer_launches[msda_windowed.KERNEL_NAME]}),
        (msda_windowed.BWD_KERNEL_NAME, "mvdetr_tpu/ops/pallas/msda_kernel_bwd.py:43", b2,
         b2_errs + shadow["b2"]["errs"],
         {"train": train_launches[msda_windowed.BWD_KERNEL_NAME], "cli": cli_launches[msda_windowed.BWD_KERNEL_NAME],
          "trainer": trainer_launches[msda_windowed.BWD_KERNEL_NAME]}),
        (warp.KERNEL_NAME, "mvdetr_tpu/ops/pallas/warp_bwd.py:43", b3, b3["errs"] + shadow["b3"]["errs"],
         {"train": train_launches[warp.KERNEL_NAME], "cli": cli_launches[warp.KERNEL_NAME],
          "trainer": trainer_launches[warp.KERNEL_NAME]}),
    ]
    for name, _, _, _, by_path in records:
        by_path["shadow"] = sum(shadow_by_path[name].values())
        by_path["gather"] = gather_launches["serve"][name] + gather_launches["train"][name]
        by_path["aio"] = aio_launches["serve"][name] + aio_launches["train"][name]
        by_path["checkpoint"] = sum(run[name] for run in ckpt["launches"].values())
        by_path["nccl"] = nccl["launches"][name]
        by_path["composed_view_shards"] = view["launches"][name]
        by_path["visualize"] = visualize_launches[name]
        for config, runs in variant_launches.items():
            by_path[config] = sum(run[name] for run in runs.values())
        for path, launches in script_launches.items():
            by_path[path] = launches[name]
    check(records[2][4]["gather"] > 0 and records[2][4]["aio"] > 0, "gather and aio: B3 launched no time")
    check(records[0][4]["checkpoint"] > 0, "checkpoint: B1 launched no time")
    for path, per_step in (("hard_benchmark", (3, 3, 1)), ("disk", (3, 3, 1)), ("day_one", (3, 0, 0))):
        for rec, kernel_launches in zip(records, per_step):
            check(kernel_launches == 0 or rec[4][path] > 0, f"{path}: {rec[0]} launched no time")
    for config in VARIANTS:
        for rec, kernel_launches in zip(records, FULL_WIDTH[config][3]):
            check(kernel_launches == 0 or rec[4][config] > 0, f"{config}: {rec[0]} launched no time")
    rows = [{
        "name": name,
        "route": "cuda",
        "source": f"mvdetr_tpu_torch/csrc/{name}.cu",
        "replaces": replaces,
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "max_abs_err": max(errs),
        "ms": rec["ms"],
        "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"],
        "library_ms": rec.get("library_ms"),
    } for name, replaces, rec, errs, by_path in records]
    # B1: the times at integer offsets and at R=16
    rows[0].update({k: b1[k] for k in ("ms_integer", "ms_R16")})
    # B2: its two sides, each beside its bound, the times at integer offsets and the query side's at R=16
    rows[1].update({k: b2[k] for k in ("value_ms", "query_ms", "value_bound_ms", "query_bound_ms", "ms_integer",
                                       "value_ms_integer", "query_ms_integer", "query_ms_R16")})
    # B3: its device time by stage, the flagship's segments
    rows[2].update({k: b3[k] for k in ("device_ms", "memset_ms", "step_ms", "segments")})
    # the shadow path: launches by path, and each kernel's times at the shadow shape beside its bound
    for row, key in zip(rows, ("b1", "b2", "b3")):
        rec = shadow[key]
        row["shadow_launches_by_path"] = shadow_by_path[row["name"]]
        row.update({f"{k}_shadow": rec[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")})
    rows[0]["ms_integer_shadow"] = shadow["b1"]["ms_integer"]
    rows[1].update({f"{k}_shadow": shadow["b2"][k] for k in ("value_ms", "query_ms", "value_bound_ms",
                                                             "query_bound_ms", "ms_integer")})
    rows[2].update({f"{k}_shadow": shadow["b3"][k] for k in ("library_ms", "device_ms", "segments")})
    # gather mode: B3 at the coordinates of the flagship's gather backward (and aio's), the attention layer's times
    # (plain forward, B3 backward) and its errors against the CPU and against B1/B2; B1 at the checkpoint's radius
    rows[2].update({f"{k}_gather": gather["b3"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                                              "device_ms", "segments")})
    rows[2]["max_abs_err"] = max(rows[2]["max_abs_err"], *gather["b3"]["errs"])
    rows[2]["aio_gather"] = gather["b3"]["aio"]
    # deform_conv: B3 at the coordinates of its input gradient (f32, C=128, 14 maps of 9*120*360 taps)
    rows[2].update({f"{k}_deform_conv": deform[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                                             "device_ms", "segments", "module_ms")})
    rows[2]["max_abs_err"] = max(rows[2]["max_abs_err"], deform["err"])
    rows[2]["gather_layer_ms"] = gather["times"]
    rows[2]["gather_attention_max_abs_err"] = max(gather["errs"])
    rows[0]["checkpoint_radius"] = ckpt["radius"]
    rows[0]["nccl_step_ms"] = {"sharded": nccl["sharded_step_ms"], "plain": nccl["plain_step_ms"]}
    # camera sharding: one view rank's time beside its bound, its plain version's and the unsharded kernel's, by
    # "cameras/ranks" (the launches of the one-process composition at 7 ranks are under composed_view_shards)
    for row, key in zip(rows, ("fwd", "bwd", "b3")):
        row["view_rank"] = {case: dict(rec[key], cameras_per_rank=rec["cameras_per_rank"])
                            for case, rec in view["by_shards"].items()}
    rows[1]["view_g_value_err"] = max([view["g_value_err"]] + [rec["g_value_err"] for rec in view["by_shards"].values()])
    # B1 and B2 in row_halo mode: one BEV shard at the flagship shape (2 shards; 4 and 6 under by_shards), launches
    # from the counted one-process composition over 2 shards (compose_bev_shards: the model's sharded path needs a
    # process per shard, and the card's machine runs one)
    for name, replaces, key in ((msda_windowed.KERNEL_NAME, "mvdetr_tpu/ops/pallas/msda_kernel.py:95", "fwd"),
                                (msda_windowed.BWD_KERNEL_NAME, "mvdetr_tpu/ops/pallas/msda_kernel_bwd.py:43", "bwd")):
        rec = halo[key]
        rows.append({
            "name": f"{name}:row_halo", "route": "cuda", "source": f"mvdetr_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": rec["launches"],
            "launches_by_path": {"composed_bev_shards": rec["launches"]},
            "max_abs_err": max(rec["errs"]), "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None, "shards": ROW_HALO_SHARDS[0], "rows": rec["rows"],
            "by_shards": rec["by_shards"], "unsharded_ms": halo["unsharded_ms"][key],
        })
    # B5: times at the T=151,200 size; the T=1104 ones and the 1-repetition times beside them
    tile, big = sorted(b5["matmul"]["by_T"])
    rows += [{
        "name": f"{lane_broadcast.KERNEL_NAME}:{variant}",
        "route": "cuda",
        "source": f"mvdetr_tpu_torch/csrc/{lane_broadcast.KERNEL_NAME}.cu",
        "replaces": lane_broadcast.TPU_BODIES[variant],
        "launches": b5[variant]["launches"] + cli_launches[f"{lane_broadcast.KERNEL_NAME}:{variant}"]
        + trainer_launches[f"{lane_broadcast.KERNEL_NAME}:{variant}"],
        "launches_by_path": {"experiment": b5[variant]["launches"],
                             "cli": cli_launches[f"{lane_broadcast.KERNEL_NAME}:{variant}"],
                             "trainer": trainer_launches[f"{lane_broadcast.KERNEL_NAME}:{variant}"],
                             **{path: launches[f"{lane_broadcast.KERNEL_NAME}:{variant}"]
                                for path, launches in script_launches.items()}},
        "max_abs_err": max(rec[big]["err"], rec[tile]["err"]),
        "ms": rec[big]["ms"],
        "plain_ms": rec[big]["plain_ms"],
        "bound_ms": rec[big]["bound_ms"],
        "bound_by": rec[big]["bound_by"],
        "library_ms": None,
        "T": big,
        "ms_1rep": rec[big]["ms_1rep"],
        "us_per_added_rep": rec[big]["us_per_added_rep"],
        f"at_T{tile}": {k: rec[tile][k] for k in ("ms", "ms_1rep", "us_per_added_rep", "plain_ms", "bound_ms")},
    } for variant, rec in ((v, r["by_T"]) for v, r in b5.items())]
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
