"""The reference-checkpoint path against the JAX package, on the CPU. No
checkpoint can be downloaded, so each test builds its ``MultiviewDetector.pth``
from a port model (the port's names are the reference's):

- ``detect_reference_config`` and ``suggest_attn_radius`` give JAX's result on
  the same dicts (every variant's key layout, ``module.`` prefixes, the
  ``nhead`` refusal);
- ``load_torch_checkpoint`` reads a checkpoint as saved, wrapped in
  ``{"state_dict": ...}``, prefixed with ``module.`` or both; the port's
  loaded model and JAX's (``mvdetr_tpu.interop.load_torch_checkpoint``) run
  the same frames within 1e-4 of scale, in gather mode and at the radius
  ``suggest_attn_radius`` picks; a key the model does not use, a missing
  key and a checkpoint of another variant raise;
- ``--load_torch_ckpt`` through ``cli.main --device cpu`` beside JAX's CLI
  on the same checkpoint: the auto-picked radius line, the note on unbounded
  offsets, the ``kornia`` default and the mismatch ``SystemExit`` are JAX's;
  gather mode evaluates without any radius line.
"""

import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvdetr_tpu import cli as jax_cli
from mvdetr_tpu import interop as jax_interop
from mvdetr_tpu.geometry import make_synthetic_rig as jax_make_rig
from mvdetr_tpu.models import MVDeTr as JaxMVDeTr
from mvdetr_tpu_torch import cli, interop
from mvdetr_tpu_torch.geometry import make_synthetic_rig
from mvdetr_tpu_torch.models import MVDeTr
from _torch_port import few_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")

RIG = dict(num_cam=2, img_shape=(48, 96), worldgrid_shape=(32, 64))
TINY = ["-d", "synthetic", "--synthetic_cams", "2", "--synthetic_frames", "6", "--synthetic_img", "48", "96",
        "--synthetic_grid", "32", "64", "--world_reduce", "2", "--cls_thres", "0.3", "--batch_size", "2", "-j", "2"]
BIAS_SCALE = 1.6  # the radial rings reach 4 cells; scaled, 6.4: the auto-picked radius is 8


def _port_state_dict(world_feat_arch="deform_trans", n_points=4, seed=0, scale=BIAS_SCALE):
    """A seeded port model's state dict at RIG, its offset biases scaled by
    ``scale`` and noise on its zero offset / attention-weight kernels."""
    model = MVDeTr.from_rig(make_synthetic_rig(**RIG), world_reduce=2, world_feat_arch=world_feat_arch,
                            n_points=n_points, device="cpu", seed=seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("sampling_offsets.bias"):
                p.mul_(scale)
            elif name.endswith(("sampling_offsets.weight", "attention_weights.weight")):
                p.copy_(torch.randn(p.shape, generator=g) * 0.02)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _save(sd, path, wrap=False, module=False):
    if module:
        sd = {f"module.{k}": v for k, v in sd.items()}
    torch.save({"state_dict": sd} if wrap else sd, str(path))
    return str(path)


def _fake_layouts():
    """Key layouts of the other variants (shapes only, a few keys each)."""
    z = np.zeros
    common = {"base.0.weight": z((64, 3, 7, 7)), "bottleneck.0.weight": z((128, 512, 1, 1)),
              "img_heatmap.0.weight": z((1, 128, 1, 1))}
    return {
        "trans": {**common, "world_feat.encoder.layers.0.self_attn.in_proj_weight": z((384, 128))},
        "deform_conv": {**common, "world_feat.deform_conv.0.weight": z((128, 128, 3, 3)),
                        "world_feat.deform_conv.1.weight": z((128, 128, 3, 3))},
        "conv": {**common, "world_feat.world_feat.0.weight": z((128, 128, 3, 3))},
        "vgg11-outfeat": {**common, "base.0.weight": z((64, 3, 3, 3)), "img_heatmap.0.weight": z((32, 128, 3, 3)),
                          "img_heatmap.2.weight": z((1, 32, 1, 1))},
    }


@pytest.fixture(scope="module")
def checkpoints():
    return {"deform_trans": _port_state_dict(), "deform_trans-8": _port_state_dict(n_points=8, seed=2),
            "aio": _port_state_dict("aio", seed=3)}


def test_detect_reference_config_matches_jax(checkpoints):
    dicts = {**{k: {n: v.numpy() for n, v in sd.items()} for k, sd in checkpoints.items()}, **_fake_layouts()}
    dicts["module-prefixed"] = {f"module.{k}": v for k, v in dicts["deform_trans"].items()}
    for name, sd in dicts.items():
        assert interop.detect_reference_config(sd) == jax_interop.detect_reference_config(sd), name
    assert interop.detect_reference_config(dicts["deform_trans-8"])["n_points"] == 8
    assert interop.detect_reference_config(dicts["aio"])["world_feat_arch"] == "aio"
    bad = dict(dicts["deform_trans"])
    # 4 heads x 2 cameras x 3 points x 2: no whole point count at the assumed 8 heads
    bad["world_feat.encoder.layers.0.self_attn.sampling_offsets.weight"] = np.zeros((4 * 2 * 3 * 2, 128))
    with pytest.raises(ValueError, match="nhead=8") as ours:
        interop.detect_reference_config(bad)
    with pytest.raises(ValueError) as ref:
        jax_interop.detect_reference_config(bad)
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("scale", [0.5, 1.0, 1.6, 2.4, 5.0])
def test_suggest_attn_radius_matches_jax(checkpoints, scale):
    """At the default bounds and at others, for biases reaching 2 to 20 cells."""
    sd = {k: v * scale if k.endswith("sampling_offsets.bias") else v for k, v in checkpoints["deform_trans"].items()}
    np_sd = {f"module.{k}": v.numpy() for k, v in sd.items()}
    for kw in ({}, {"lo": 2, "hi": 10}):
        ours, ref = interop.suggest_attn_radius(sd, **kw), jax_interop.suggest_attn_radius(np_sd, **kw)
        assert ours[0] == ref[0] and ours[1] == pytest.approx(ref[1], rel=0, abs=0)
    assert interop.suggest_attn_radius({"base.0.weight": torch.zeros(1)}) == (4, 0.0)


@pytest.mark.parametrize("wrap,module", [(False, False), (True, False), (False, True), (True, True)],
                         ids=["plain", "state_dict", "module", "state_dict+module"])
def test_load_torch_checkpoint_as_saved_and_wrapped(checkpoints, tmp_path, wrap, module):
    sd = checkpoints["deform_trans"]
    path = _save(sd, tmp_path / "MultiviewDetector.pth", wrap, module)
    model = MVDeTr.from_rig(make_synthetic_rig(**RIG), world_reduce=2, device="cpu", seed=9)
    loaded, cfg = interop.load_torch_checkpoint(path, model, with_config=True)
    assert loaded is model
    assert cfg == {"arch": "resnet18", "bottleneck_dim": 128, "outfeat_dim": 0, "world_feat_arch": "deform_trans",
                   "num_cam": 2, "n_points": 4}
    for k, v in sd.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(model.state_dict()[k], v), k


@pytest.mark.parametrize("arch", ["deform_trans", "aio"])
def test_port_and_jax_loaders_run_the_same_frames(checkpoints, tmp_path, arch):
    """Both loaders on one ``{"state_dict": {"module." + k: v}}`` file;
    both models on the same uint8 frames, f32, within 1e-4 of scale: gather
    mode, and for deform_trans also windowed at the auto-picked radius
    (with a ~0.02 offset kernel a few offsets pass the bias's reach)."""
    path = _save(checkpoints[arch], tmp_path / "MultiviewDetector.pth", wrap=True, module=True)
    jvars = jax_interop.load_torch_checkpoint(path)
    radius, _ = interop.suggest_attn_radius(interop.read_torch_checkpoint(path))
    assert radius == 8
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 256, (2, 2, 32, 64, 3), dtype=np.uint8)
    aff = np.tile(np.eye(3, dtype=np.float32), (2, 2, 1, 1))
    aff[1, 0] = [[1.05, 0.02, -3.0], [-0.01, 0.97, 2.0], [0, 0, 1]]
    modes = ("gather", "auto") if arch == "deform_trans" else ("auto",)
    for mode in modes:
        kw = dict(world_reduce=2, world_feat_arch=arch, attn_mode=mode, attn_radius=radius,
                  warp_convention="kornia")
        jm = JaxMVDeTr.from_rig(jax_make_rig(**RIG), **kw)
        ref = jax.jit(lambda v, i, a: jm.apply(v, i, a, train=False))(jvars, jnp.asarray(imgs), jnp.asarray(aff))
        model = interop.load_torch_checkpoint(path, MVDeTr.from_rig(make_synthetic_rig(**RIG), device="cpu", **kw))
        with torch.no_grad():
            ours, _ = model(torch.from_numpy(imgs), torch.from_numpy(aff))
        for o, r in zip((*ours[0], *ours[1]), jax.tree.leaves(ref)):
            r = np.asarray(r)
            np.testing.assert_allclose(o.numpy(), r, rtol=0, atol=1e-4 * max(1.0, float(np.abs(r).max())),
                                       err_msg=mode)


def test_load_torch_checkpoint_is_strict(checkpoints, tmp_path):
    """An unused key, a missing key, a shape that differs and a checkpoint of
    another variant each raise (JAX's converter refuses the unused key too).
    Every variant is ported, so a fake layout fails on its keys, not for
    being a variant the port lacks."""
    sd = dict(checkpoints["deform_trans"])
    model = MVDeTr.from_rig(make_synthetic_rig(**RIG), world_reduce=2, device="cpu")
    extra = _save({**sd, "world_feat.extra.weight": torch.zeros(3)}, tmp_path / "extra.pth", wrap=True)
    with pytest.raises(ValueError, match=r"unexpected \['world_feat.extra.weight'\]"):
        interop.load_torch_checkpoint(extra, model)
    with pytest.raises(ValueError, match="unconsumed checkpoint keys"):
        jax_interop.load_torch_checkpoint(extra)
    missing = {k: v for k, v in sd.items() if k != "world_offset.0.bias"}
    with pytest.raises(ValueError, match=r"missing \['world_offset.0.bias'\]"):
        interop.load_torch_checkpoint(_save(missing, tmp_path / "missing.pth"), model)
    wrong = {**sd, "world_offset.0.bias": torch.zeros(3)}
    with pytest.raises(ValueError, match=r"shapes differ at \['world_offset.0.bias'\]"):
        interop.load_torch_checkpoint(_save(wrong, tmp_path / "wrong.pth"), model)
    for name, fake in _fake_layouts().items():
        path = _save({k: torch.from_numpy(v) for k, v in fake.items()}, tmp_path / f"{name}.pth")
        with pytest.raises(ValueError, match="reference checkpoint do not match the model: missing"):
            interop.load_torch_checkpoint(path, model)


def _run(main, argv):
    saved = sys.stdout
    try:
        return main(argv)
    finally:
        if sys.stdout is not saved:
            sys.stdout.close()
        sys.stdout = saved


def _lines(log, *starts):
    return [line for line in log.splitlines() if line.startswith(starts)]


def test_cli_load_torch_ckpt_matches_the_jax_cli(checkpoints, tmp_path, monkeypatch):
    """The same checkpoint through both CLIs at their defaults (``auto``,
    no ``--attn_radius``): the same radius line and note (the port's says
    nothing of gather's speed), ``kornia``, an
    evaluation and no training; a wrong ``--n_points`` exits with the same
    message. The port in gather mode prints no radius line and still
    evaluates.

    The JAX CLI turns on the persistent compilation cache and the
    ``unsafe_rbg`` PRNG for its whole process (`mvdetr_tpu/utils/cache.py`);
    both are left off here, so the tests that run after this one in the
    same worker compile and draw as before (the checkpoint replaces every
    weight the PRNG would draw)."""
    from mvdetr_tpu.utils import cache as jax_cache

    monkeypatch.setattr(jax_cache, "enable_compilation_cache", lambda *a, **k: None)
    monkeypatch.setattr(jax_cache, "use_fast_prng", lambda: None)
    monkeypatch.chdir(tmp_path)
    path = _save(checkpoints["deform_trans"], tmp_path / "MultiviewDetector.pth")
    jtrainer = _run(jax_cli.main, TINY + ["--load_torch_ckpt", path])
    jlog = next((tmp_path / "logs" / "synthetic").iterdir()) / "log.txt"
    jlog = jlog.read_text()
    ours = _run(cli.main, TINY + ["--device", "cpu", "--load_torch_ckpt", path, "--logdir", "auto"])
    log = (tmp_path / "auto" / "log.txt").read_text()
    radius = _lines(log, "auto attn_radius")
    assert radius == _lines(jlog, "auto attn_radius") == [
        "auto attn_radius 8 (checkpoint max |sampling_offsets bias| 6.40 cells; override with --attn_radius N, "
        "exact semantics with --attn_mode gather)"]
    # the port's note is JAX's but for gather's speed: on the card gather mode runs its own kernels
    assert _lines(log, "NOTE: reference", "Loading reference") == [
        line.replace("reference-exact (slow). The fast paths", "reference-exact (unclamped offsets). The windowed "
                     "and warped paths") for line in _lines(jlog, "NOTE: reference", "Loading reference")]
    assert len(_lines(log, "NOTE: reference")) == 1
    model = ours.state.model
    assert model.warp_convention == "kornia" == jtrainer.state.apply_fn.__self__.warp_convention
    assert model.world_feat.mode == "windowed" and model.world_feat.encoder.layers[0].self_attn.radius == 8
    assert ours.state.step == 0 and "Train epoch" not in log and "Test loaded model..." in log
    assert len(_lines(log, "Test: loss")) == 1 and "Eval offset_clip_fraction" in log
    for k, v in checkpoints["deform_trans"].items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(model.state_dict()[k], v), k

    gathered = _run(cli.main, TINY + ["--device", "cpu", "--load_torch_ckpt", path, "--attn_mode", "gather",
                                      "--logdir", "gather"])
    glog = (tmp_path / "gather" / "log.txt").read_text()
    assert gathered.state.model.world_feat.mode == "gather"
    assert not _lines(glog, "auto attn_radius", "NOTE: reference") and len(_lines(glog, "Test: loss")) == 1

    wrong = ["--n_points", "8", "--load_torch_ckpt", path]
    with pytest.raises(SystemExit) as mine:
        _run(cli.main, TINY + ["--device", "cpu", "--logdir", "wrong"] + wrong)
    with pytest.raises(SystemExit) as theirs:
        _run(jax_cli.main, TINY + wrong)
    assert str(mine.value) == str(theirs.value)
    assert str(mine.value).endswith("rerun with: --n_points 4")
