"""Smoke run of the PyTorch port (``mvdetr_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code:

1. card name and power limit, torch and CUDA versions; build the CUDA kernel from
   ``mvdetr_tpu_torch/csrc`` (timed);
2. the windowed deformable-attention kernel against its plain PyTorch
   version on the card, at the flagship shape (random offsets past the
   clamp, and integer offsets) and at narrow shapes (M*D=32 at R=1 and R=8);
   kernel and plain version timed with CUDA events;
3. a small model on the card against the same weights on the CPU, in f32;
4. serving at Wildtrack width: 7 cameras, 720x1280 uint8 frames (1080x1920
   rig frames at img_reduce=12), 120x360 BEV, 60x180 encoder grid, shadow
   transformer at n_points=4 and radius 4, bf16 compute, batch 2; one
   warm-up and three timed requests through ``eval_step``, which must launch
   the kernel 3 times each;
5. one JSON line per run with each kernel's launches, error, times and bound.

The line before the last is the card's ``name, power.limit`` as nvidia-smi
reports them; the last line is ``{"ok": true, "device": {...}}``. Imports
nothing of JAX. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOP_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
KERNEL_ATOL = 5e-5  # f32 sums of L*P=28 samples in another order; outputs |x| < ~5
SMALL_MODEL_RTOL = 2e-2  # card stages the attention value in bf16 (2^-9 relative), the CPU keeps f32


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


def perturb_attention(model, seed: int, scale: float = 0.05) -> None:
    """Random weights for the zero-initialised offset and attention-weight
    projections, so offsets vary per query and some bind the clamp."""
    import torch

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("sampling_offsets.weight", "attention_weights.weight")):
                p.copy_(torch.randn(p.shape, generator=g) * scale)


def kernel_case(name, b, l, h, w, m, d, p, radius, integer, rng, timed):
    """Kernel vs plain version on the card at one shape; returns a record."""
    import torch

    from mvdetr_tpu_torch.models.deformable import radial_offset_bias
    from mvdetr_tpu_torch.ops.msda_windowed import ms_deform_attn_windowed, msda_windowed_fwd

    c = l
    value = torch.from_numpy(rng.standard_normal((b, l, h, w, m, d), dtype=np.float32))
    if integer:
        bias = radial_offset_bias(m, l, p, max_radius=radius).reshape(m, l, p, 2)
        off = bias + rng.integers(-2, 3, (b, c, h, w, m, l, p, 2))
    else:
        off = rng.uniform(-radius - 2.0, radius + 2.0, (b, c, h, w, m, l, p, 2))
    logits = torch.from_numpy(rng.standard_normal((b, c, h, w, m, l * p), dtype=np.float32))
    wgt = torch.softmax(logits, -1).reshape(b, c, h, w, m, l, p)
    v = value.cuda().to(torch.bfloat16)
    o = torch.from_numpy(off.astype(np.float32)).cuda()
    wg = wgt.cuda()
    out = msda_windowed_fwd(v, o, wg, radius)
    ref = ms_deform_attn_windowed(v, o, wg, radius, flatten=False)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    print(f"kernel {name}: B={b} L=C={l} {h}x{w} M={m} D={d} P={p} R={radius} "
          f"max_abs_err={err:.3e} (max |out| {float(ref.abs().max()):.3f}, clamp binds "
          f"{float((o.abs() > radius).float().mean()):.3f} of offsets)")
    check(bool(torch.isfinite(out).all()), f"kernel {name}: non-finite output")
    check(err <= KERNEL_ATOL, f"kernel {name}: max abs error {err} > {KERNEL_ATOL}")
    rec = {"err": err}
    if timed:
        nbytes = v.numel() * 2 + o.numel() * 4 + wg.numel() * 4 + out.numel() * 4
        flops = 10 * out.numel() * l * p  # 4 taps x (mul+add) + weight FMA per (query, channel, sample)
        rec["bound_ms"] = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S) * 1e3
        rec["bound_by"] = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOP_PER_S else "operations"
        rec["ms"] = cuda_ms(lambda: msda_windowed_fwd(v, o, wg, radius), 20)
        rec["plain_ms"] = cuda_ms(lambda: ms_deform_attn_windowed(v, o, wg, radius, flatten=False), 10)
        print(f"kernel {name}: kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.3f} ms, bound "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}; {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
    return rec


def small_model_card_vs_cpu() -> None:
    import copy

    import torch

    from mvdetr_tpu_torch.geometry import make_synthetic_rig
    from mvdetr_tpu_torch.models import MVDeTr

    saved = (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())
    torch.backends.cudnn.allow_tf32 = False  # cuDNN's f32 default is TF32
    torch.set_float32_matmul_precision("highest")
    rig = make_synthetic_rig(num_cam=3, img_shape=(96, 160), worldgrid_shape=(48, 96))
    cpu_model = MVDeTr.from_rig(rig, world_reduce=2, img_reduce=12, device="cpu", seed=1)
    perturb_attention(cpu_model, seed=2)
    card_model = copy.deepcopy(cpu_model).cuda()
    rng = np.random.default_rng(3)
    imgs = torch.from_numpy(rng.integers(0, 256, (2, 3, 64, 106, 3), dtype=np.uint8))
    aff = torch.from_numpy(np.tile(np.eye(3, dtype=np.float32), (2, 3, 1, 1)))
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
    torch.backends.cudnn.allow_tf32 = saved[0]  # serving runs with the library defaults
    torch.set_float32_matmul_precision(saved[1])


def serve_full_width():
    import torch

    from mvdetr_tpu_torch.geometry import make_synthetic_rig
    from mvdetr_tpu_torch.models import MVDeTr
    from mvdetr_tpu_torch.ops.msda_windowed import msda_windowed_fwd
    from mvdetr_tpu_torch.train import eval_step

    # the rig of bench.py: 1080x1920 frames (720x1280 input at img_reduce=12),
    # a 480x1440 grid (120x360 BEV at world_reduce=4, 60x180 encoder grid)
    rig = make_synthetic_rig(
        num_cam=7, img_shape=(1080, 1920), worldgrid_shape=(480, 1440),
        cell_meters=0.025, indexing="ij", worldcoord_unit=0.01, origin_offset=(-300.0, -900.0),
        camera_height_m=6.0, camera_margin_m=4.0, name="BenchWildtrack",
    )
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
    for i in range(1 + n_timed):
        t0 = time.perf_counter()
        aux, xys, keep = eval_step(model, batch, world_reduce=4, num_candidates=512, nms_dist=20.0)
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
        check(tuple(xys.shape) == (batch_size, 512, 3) and tuple(keep.shape) == (batch_size, 512),
              f"serve: shapes {tuple(xys.shape)}, {tuple(keep.shape)}")
        check(bool(torch.isfinite(xys).all()), "serve: non-finite detections")
        check(keep.dtype == torch.bool and int(keep.sum()) > 0, "serve: no detection kept")
    launches = msda_windowed_fwd.launches
    check(launches == 3 * (1 + n_timed), f"serve: kernel launched {launches} times in {1 + n_timed} requests")
    timed = latencies[1:]
    med = float(np.median(timed))
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"serve: warm-up {latencies[0]:.1f} ms, timed requests (ms) {[round(t, 3) for t in timed]}, "
          f"median {med:.3f} ms, {batch_size / (med / 1e3):.3f} frame-sets/s, peak memory {peak:.2f} GiB")
    print(f"serve: kept detections per frame set {keep.sum(1).tolist()}, offset_clip_fraction "
          f"{float(aux['offset_clip_fraction']):.4f}, kernel launches {launches} in {1 + n_timed} requests")

    # where one request's device time goes (after the counted run)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eval_step(model, batch, world_reduce=4, num_candidates=512, nms_dist=20.0)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.key.startswith("Activity Buffer")]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    msda = sum(e.self_device_time_total for e in kernels if "msda_windowed_fwd" in e.key) / 1e3
    print(f"serve profile: {busy:.3f} ms of device activity in one request ({busy / med:.3f} of the median "
          f"request time), of which msda_windowed_fwd {msda:.3f} ms; top device activities:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  {e.key[:110]}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from mvdetr_tpu_torch.ops import kernel_build
    from mvdetr_tpu_torch.ops.msda_windowed import KERNEL_NAME, load_library

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    lib_path = kernel_build.build(KERNEL_NAME)
    load_library()
    print(f"build: {KERNEL_NAME} in {time.perf_counter() - t0:.1f} s -> {os.path.relpath(lib_path, ROOT)}")
    print((lib_path.parent / "build.log").read_text().strip())

    rng = np.random.default_rng(0)
    flagship = dict(b=2, l=7, h=60, w=180, m=8, d=16, p=4, radius=4)
    rec = kernel_case("flagship-random", **flagship, integer=False, rng=rng, timed=True)
    rec_int = kernel_case("flagship-integer", **flagship, integer=True, rng=rng, timed=False)
    errs = [rec["err"], rec_int["err"]]
    for radius in (1, 8):
        errs.append(kernel_case(f"narrow-R{radius}", b=1, l=3, h=60, w=180, m=2, d=16, p=4, radius=radius,
                                integer=False, rng=rng, timed=False)["err"])

    small_model_card_vs_cpu()
    launches = serve_full_width()

    print(json.dumps({"kernels": [{
        "name": KERNEL_NAME,
        "route": "cuda",
        "source": "mvdetr_tpu_torch/csrc/msda_windowed_fwd.cu",
        "replaces": "mvdetr_tpu/ops/pallas/msda_kernel.py:95",
        "launches": launches,
        "max_abs_err": max(errs),
        "ms": rec["ms"],
        "kernel_ms": rec["ms"],
        "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"],
        "library_ms": None,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
