"""Smoke run of the PyTorch port (``mvdetr_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code:

1. card name and power limit, torch and CUDA versions; build the four CUDA
   kernels from ``mvdetr_tpu_torch/csrc`` (one ``nvcc`` each, all started
   together; timed) and print each build log;
2. B1, the windowed deformable-attention forward, against its plain PyTorch
   version on the card, two launches bitwise equal: at the flagship shape
   (random offsets past the clamp, and integer offsets; both timed), at
   narrow shapes (M*D=32 at R=0, 1, 8, 12 and 16; a 37x101 grid; D=8, 32
   and 5; 5 cameras over 3 levels), and, timed, at the flagship shape at
   R=16 (R=12 and 16 close B4, the TPU's large-radius variant);
3. B2, its backward, against the plain backward: at the flagship shape
   (random offsets past the clamp; the radial init shifted by integers, where
   exactly integer offsets must get exactly zero cotangents), both timed
   whole and by side (value side, query side, each beside its bound), at
   narrow shapes (R=0, 1, 8, 12 and 16; a 37x101 grid; D=8, 32 and 5;
   5 cameras over 3 levels), and at the flagship shape at R=16 (query side
   timed); two launches must be bitwise equal; each case prints the query
   side's plan;
4. B3, the warp backward, against its plain version at the flagship shape
   (g [14, 43200, 128] bf16 at the coordinates of the bench rig's homographies
   with non-identity augmentation affines) and a narrow f32 shape; bitwise
   repeat; ``grad_input`` of ``aten.grid_sampler_2d_backward`` timed beside it;
   kernels and plain versions timed with CUDA events;
5. B5, the lane broadcast / reduce experiment: each of its six variants
   against its plain version at T=1104 and T=151,200 rows (within 1e-5 of
   the largest output), the variants against each other (``repeat`` tiles,
   so it must differ from the three broadcasts), the plain versions timed;
   then the experiment's entry point
   (``mvdetr_tpu_torch.scripts.exp_vpu_broadcast.main``) as the counted run,
   which times every variant at 81 repetitions and at 1, at both sizes;
6. a small model on the card against the same weights on the CPU, in f32:
   the inference forward, then one train step (loss, gradients, updated
   parameters and BatchNorm statistics);
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
9. one JSON line with each kernel's launches, error, times and bound.

The line before the last is the card's ``name, power.limit`` as nvidia-smi
reports them; the last line is ``{"ok": true, "device": {...}}``. Imports
nothing of JAX. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import copy
import json
import math
import os
import subprocess
import sys
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


def bench_rig():
    """The rig of bench.py: 1080x1920 frames (720x1280 input at img_reduce=12),
    a 480x1440 grid (120x360 BEV at world_reduce=4, 60x180 encoder grid)."""
    from mvdetr_tpu_torch.geometry import make_synthetic_rig

    return make_synthetic_rig(
        num_cam=7, img_shape=(1080, 1920), worldgrid_shape=(480, 1440),
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


def attention_inputs(rng, b, l, h, w, m, d, p, radius, integer, c=None):
    """bf16 value, f32 offsets (uniform past the clamp, or the radial init
    shifted by integers) and softmax weights, on the card; ``c`` cameras
    (default ``l``)."""
    import torch

    from mvdetr_tpu_torch.models.deformable import radial_offset_bias

    c = l if c is None else c
    value = torch.from_numpy(rng.standard_normal((b, l, h, w, m, d), dtype=np.float32))
    if integer:
        off = radial_offset_bias(m, l, p, max_radius=radius).reshape(m, l, p, 2) + rng.integers(
            -2, 3, (b, c, h, w, m, l, p, 2))
    else:
        off = rng.uniform(-radius - 2.0, radius + 2.0, (b, c, h, w, m, l, p, 2))
    logits = torch.from_numpy(rng.standard_normal((b, c, h, w, m, l * p), dtype=np.float32))
    wgt = torch.softmax(logits, -1).reshape(b, c, h, w, m, l, p)
    return value.cuda().to(torch.bfloat16), torch.from_numpy(off.astype(np.float32)).cuda(), wgt.cuda()


def fwd_case(name, b, l, h, w, m, d, p, radius, integer, rng, timed, c=None):
    """B1 vs its plain version on the card at one shape (``c`` cameras,
    default ``l``); two launches must be bitwise equal. Returns a record."""
    import torch

    from mvdetr_tpu_torch.ops.msda_windowed import _fwd_plan, _value_align, ms_deform_attn_windowed, msda_windowed_fwd

    c = l if c is None else c
    v, o, wg = attention_inputs(rng, b, l, h, w, m, d, p, radius, integer, c=c)
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


def bwd_case(name, b, l, h, w, m, d, p, radius, integer, rng, timed, c=None):
    """B2 vs the plain backward on the card at one shape (``c`` cameras,
    default ``l``); when ``timed``, the whole launch, its value side and its
    query side are timed, each beside its bound (``timed="query"``: the
    query side alone). Returns a record."""
    import torch

    from mvdetr_tpu_torch.ops.msda_windowed import _query_plan, ms_deform_attn_windowed_bwd, msda_windowed_bwd

    c = l if c is None else c
    v, o, wg = attention_inputs(rng, b, l, h, w, m, d, p, radius, integer, c=c)
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


def warp_case(name, g, sx, sy, h, w, bev_hw=None):
    """B3 vs the plain version on the card; timed when the samples' BEV grid
    ``bev_hw`` is given. Returns a record."""
    import torch

    from mvdetr_tpu_torch.ops.sampling import bilinear_scatter_matmul
    from mvdetr_tpu_torch.ops.warp import warp_bwd

    out = warp_bwd(g, sx, sy, h, w)
    again = warp_bwd(g, sx, sy, h, w)
    ref = bilinear_scatter_matmul(g, sx, sy, h, w)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    rtol = WARP_RTOL if g.dtype == torch.bfloat16 else 0.0
    worst = float((diff - rtol * ref.float().abs()).max())
    print(f"B3 {name}: g {tuple(g.shape)} {g.dtype} -> {tuple(out.shape)}, max_abs_err={err:.3e} "
          f"(max |ref| {float(ref.float().abs().max()):.3f}), taps inside the map "
          f"{float(((sx >= -1) & (sx <= w) & (sy >= -1) & (sy <= h)).float().mean()):.3f}, bitwise repeat")
    check(bool(torch.isfinite(out).all()), f"B3 {name}: non-finite output")
    check(worst <= 1e-5, f"B3 {name}: error {err} beyond rtol {rtol} + 1e-5")
    check(torch.equal(out, again), f"B3 {name}: two launches differ")
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
    ``names`` maps a label to the substrings of its device kernels' names."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.key.startswith("Activity Buffer")]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    ours = {n: sum(e.self_device_time_total for e in kernels if any(k in e.key for k in keys)) / 1e3
            for n, keys in names.items()}
    print(f"{label} profile: {busy:.3f} ms of device activity ({busy / wall_ms:.3f} of the median wall time), of "
          f"which " + ", ".join(f"{n} {t:.3f} ms" for n, t in ours.items()) + "; top device activities:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:20]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  {e.key[:110]}")


def serve_full_width(rig):
    import torch

    from mvdetr_tpu_torch.models import MVDeTr
    from mvdetr_tpu_torch.ops.msda_windowed import msda_windowed_fwd
    from mvdetr_tpu_torch.train import eval_step

    batch_size, n_timed = 2, 3
    model = MVDeTr.from_rig(rig, world_reduce=4, img_reduce=12, compute_dtype=torch.bfloat16,
                            attn_radius=4, n_points=4, device="cuda", seed=0)
    perturb_attention(model, seed=1)
    check(model.world_feat.mode == "windowed", f"attention mode {model.world_feat.mode}, expected windowed")
    rng = np.random.default_rng(0)
    batch = {"imgs": rng.integers(0, 256, (batch_size, 7, 720, 1280, 3), dtype=np.uint8),
             "affine_mats": np.tile(np.eye(3, dtype=np.float32), (batch_size, 7, 1, 1))}

    torch.cuda.reset_peak_memory_stats()
    msda_windowed_fwd.launches = 0
    latencies = []
    for _ in range(1 + n_timed):
        t0 = time.perf_counter()
        aux, xys, keep = eval_step(model, batch, world_reduce=4, num_candidates=512, nms_dist=20.0)
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
        check(tuple(xys.shape) == (batch_size, 512, 3) and tuple(keep.shape) == (batch_size, 512),
              f"serve: shapes {tuple(xys.shape)}, {tuple(keep.shape)}")
        check(bool(torch.isfinite(xys).all()), "serve: non-finite detections")
        check(keep.dtype == torch.bool and int(keep.sum()) > 0, "serve: no detection kept")
    launches = msda_windowed_fwd.launches
    check(launches == 3 * (1 + n_timed), f"serve: B1 launched {launches} times in {1 + n_timed} requests")
    timed = latencies[1:]
    med = float(np.median(timed))
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"serve: warm-up {latencies[0]:.1f} ms, timed requests (ms) {[round(t, 3) for t in timed]}, "
          f"median {med:.3f} ms (with F.interpolate: {INTERP_SERVE_MS} ms), "
          f"{batch_size / (med / 1e3):.3f} frame-sets/s, peak memory {peak:.2f} GiB")
    print(f"serve: kept detections per frame set {keep.sum(1).tolist()}, offset_clip_fraction "
          f"{float(aux['offset_clip_fraction']):.4f}, B1 launches {launches} in {1 + n_timed} requests")
    profile_table("serve", lambda: eval_step(model, batch, world_reduce=4, num_candidates=512, nms_dist=20.0),
                  med, {"msda_windowed_fwd": ("msda_windowed_fwd_kernel",)})
    return launches


def train_full_width(rig, batch):
    """Returns the launch counts of the counted run, by kernel name."""
    import torch

    from mvdetr_tpu_torch.models import MVDeTr
    from mvdetr_tpu_torch.ops.msda_windowed import msda_windowed_bwd, msda_windowed_fwd
    from mvdetr_tpu_torch.ops.warp import warp_bwd
    from mvdetr_tpu_torch.train import batch_to_device, create_train_state, train_step

    batch_size, n_timed = 2, 5
    wrappers = {"msda_windowed_fwd": msda_windowed_fwd, "msda_windowed_bwd": msda_windowed_bwd,
                "warp_bwd": warp_bwd}
    model = MVDeTr.from_rig(rig, world_reduce=4, img_reduce=12, compute_dtype=torch.bfloat16, attn_radius=4,
                            n_points=4, device="cuda", seed=0)
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
        check(math.isfinite(losses[-1]), f"train: loss {losses[-1]} at step {state.step}")
    launches = {name: fn.launches for name, fn in wrappers.items()}
    steps = 1 + n_timed
    expected = {"msda_windowed_fwd": 3 * steps, "msda_windowed_bwd": 3 * steps, "warp_bwd": steps}
    check(launches == expected, f"train: launches {launches} in {steps} steps, expected {expected}")
    timed = times[1:]
    med = float(np.median(timed))
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"train: warm-up {times[0]:.1f} ms, timed steps (ms) {[round(t, 3) for t in timed]}, median {med:.3f} ms "
          f"(with F.interpolate: {INTERP_TRAIN_MS} ms), {batch_size / (med / 1e3):.3f} frame-sets/s, "
          f"peak memory {peak:.2f} GiB")
    print(f"train: losses {[round(v, 5) for v in losses]}, last step "
          + ", ".join(f"{k} {float(v):.4f}" for k, v in aux.items()) + f"; launches {launches} in {steps} steps")
    profile_table("train", lambda: train_step(state, batch, gen), med,
                  {"msda_windowed_fwd": ("msda_windowed_fwd_kernel",), "msda_windowed_bwd": ("msda_bwd_",),
                   "warp_bwd": ("warp_bwd_",)})

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
    for label, (a, b) in (("default algorithms", runs[:2]), ("deterministic algorithms", runs[2:])):
        differ = [n for n in a[0] if not torch.equal(a[0][n], b[0][n])]
        grads_differ = [n for n in a[1] if not torch.equal(a[1][n], b[1][n])]
        verdict[label] = not differ and not grads_differ and a[2] == b[2]
        print(f"train, {label}: two steps from the same state and generator give bitwise-equal parameters: "
              f"{not differ}; gradients: {not grads_differ}; losses equal: {a[2] == b[2]}; {len(differ)} of "
              f"{len(a[0])} parameter leaves and {len(grads_differ)} gradient leaves differ, the last in forward "
              f"order {grads_differ[::-1][:6]}; step {a[3]:.1f} and {b[3]:.1f} ms; warnings {a[4] + b[4]}")
    check(verdict["default algorithms"], "train: two steps with PyTorch's default algorithms are not bitwise equal")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from mvdetr_tpu_torch.ops import kernel_build, lane_broadcast, msda_windowed, warp
    from mvdetr_tpu_torch.ops.warp import warp_coords

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

    rig = bench_rig()
    batch = train_batch(rig, 2, world_reduce=4, img_reduce=12, seed=0)
    from mvdetr_tpu_torch.models import MVDeTr

    geo = MVDeTr.from_rig(rig, world_reduce=4, img_reduce=12, device="cuda")  # the path's homographies
    mats = geo.warp_mats(torch.from_numpy(batch["affine_mats"]).cuda(), (90, 160))
    geo_bev = geo.Rworld_shape
    sx, sy = warp_coords(mats, geo_bev)
    del geo
    g = torch.from_numpy(rng.standard_normal((14, sx.shape[1], 128), dtype=np.float32)).cuda().to(torch.bfloat16)
    b3 = warp_case("flagship", g, sx.contiguous(), sy.contiguous(), 90, 160, bev_hw=geo_bev)
    small = torch.from_numpy(rng.standard_normal((3, 700, 40), dtype=np.float32)).cuda()
    nx = torch.from_numpy(rng.uniform(-2.0, 18.0, (3, 700)).astype(np.float32)).cuda()
    ny = torch.from_numpy(rng.uniform(-2.0, 12.0, (3, 700)).astype(np.float32)).cuda()
    b3_errs = [b3["err"], warp_case("narrow-f32", small, nx, ny, 11, 17)["err"]]
    del g, small
    torch.cuda.empty_cache()
    b5 = lane_phase()

    small_model_card_vs_cpu()
    serve_launches = serve_full_width(rig)
    torch.cuda.empty_cache()
    train_launches = train_full_width(rig, batch)

    records = [
        (msda_windowed.KERNEL_NAME, "mvdetr_tpu/ops/pallas/msda_kernel.py:95", b1, b1_errs,
         {"serve": serve_launches, "train": train_launches[msda_windowed.KERNEL_NAME]}),
        (msda_windowed.BWD_KERNEL_NAME, "mvdetr_tpu/ops/pallas/msda_kernel_bwd.py:43", b2, b2_errs,
         {"train": train_launches[msda_windowed.BWD_KERNEL_NAME]}),
        (warp.KERNEL_NAME, "mvdetr_tpu/ops/pallas/warp_bwd.py:43", b3, b3_errs,
         {"train": train_launches[warp.KERNEL_NAME]}),
    ]
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
    # B5: times at the T=151,200 size; the T=1104 ones and the 1-repetition times beside them
    tile, big = sorted(b5["matmul"]["by_T"])
    rows += [{
        "name": f"{lane_broadcast.KERNEL_NAME}:{variant}",
        "route": "cuda",
        "source": f"mvdetr_tpu_torch/csrc/{lane_broadcast.KERNEL_NAME}.cu",
        "replaces": lane_broadcast.TPU_BODIES[variant],
        "launches": b5[variant]["launches"],
        "launches_by_path": {"experiment": b5[variant]["launches"]},
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
