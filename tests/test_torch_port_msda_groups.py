"""B1's and B2's plans over the shadow stack's pseudo-levels of one point
(``ops/msda_windowed.py``): the body each plan picks (``BODY_GROUPS`` at
P = 1, ``BODY_POINTS4`` at the flagship's P = 4), the shapes of
``scripts/msda_vs_source.py``'s shadow cases, and the bytes and bounds of
``chip_smoke.attention_bound``. Plans and counts only: the kernels, and the
value side's planes per block that B2's C entry picks, are checked on the
card (``tests/test_torch_port_cuda.py``, ``chip_smoke.py`` phase 4b)."""

import pytest

import chip_smoke
from mvdetr_tpu_torch.ops.msda_windowed import BODY_GENERIC, BODY_GROUPS, BODY_POINTS4, _fwd_plan
from mvdetr_tpu_torch.scripts import msda_vs_source
from _torch_port import VALUE_PLANES, few_torch_threads  # noqa: F401

# (h, w, pseudo-levels or levels, points) of VALUE_PLANES -> body
BODIES = {
    "shadow": BODY_GROUPS,
    "recipe-shadow": BODY_GROUPS,
    "flagship": BODY_POINTS4,
    "recipe": BODY_POINTS4,
    "ragged54": BODY_GROUPS,
    "ragged3": BODY_GROUPS,
    "ragged1": BODY_GROUPS,
    "points2": BODY_GENERIC,
    "points3": BODY_GENERIC,
}


@pytest.mark.parametrize("radius", [4, 16])
@pytest.mark.parametrize("name", sorted(BODIES))
def test_plans_pick_the_body(name, radius, few_torch_threads):
    """P = 1 stacks walk groups of 4 pseudo-levels (their tail, L mod 4,
    inside the same kernel), P = 4 the flagship's level body, other P the
    generic loop, at either radius; the tile is the flagship's."""
    (_, w, _, p), _ = VALUE_PLANES[name]
    plan = _fwd_plan(w, 8, 16, p, radius)
    assert plan.body == BODIES[name]
    assert (plan.vec, plan.tile_x, plan.threads) == (8, 16, 128 if radius < 8 else 256)


@pytest.mark.parametrize("align", [4, 8])
def test_unaligned_samples_leave_the_points4_body_only(align):
    """Offsets or weights that are not 16-byte aligned: P = 4 takes the
    generic loop; P = 1 keeps the level groups, whose threads load their
    samples one float at a time."""
    assert _fwd_plan(180, 8, 16, 4, 4, sample_align=align).body == BODY_GENERIC
    assert _fwd_plan(180, 8, 16, 1, 4, sample_align=align).body == BODY_GROUPS


def test_msda_vs_source_shadow_cases():
    """The shadow cases are ``chip_smoke.SHADOW_ATTENTION`` (random offsets,
    and the radial init of 7 cameras x 8 points) and a ragged stack of 54
    pseudo-levels."""
    cases = dict(msda_vs_source.cases("shadow"))
    assert sorted(cases) == ["shadow-integer", "shadow-ragged54", "shadow-random"]
    stack = dict(b=2, l=56, c=7, h=60, w=180, m=8, d=16, p=1, radius=4)
    for name in ("shadow-random", "shadow-integer"):
        assert {k: cases[name][k] for k in stack} == stack and cases[name]["init"] == (7, 8)
    assert cases["shadow-integer"]["integer"] and not cases["shadow-random"]["integer"]
    assert cases["shadow-ragged54"]["l"] == 54 and cases["shadow-ragged54"]["l"] % 4


# (case, kernel, side) -> (bytes, bound in ms): PERF.md's kernel table, B1 and B2
BOUNDS = {
    ("shadow-random", "fwd", "both"): (1_199_923_200, 0.358),
    ("shadow-random", "bwd", "both"): (2_632_089_600, 0.786),
    ("shadow-random", "bwd", "value"): (1_509_580_800, 0.451),
    ("shadow-random", "bwd", "query"): (2_012_774_400, 0.601),
    ("flagship-random", "fwd", "both"): (522_547_200, 0.156),
    ("flagship-random", "bwd", "both"): (1_006_387_200, 0.300),
    ("flagship-random", "bwd", "value"): (561_254_400, 0.168),
    ("flagship-random", "bwd", "query"): (928_972_800, 0.277),
}


@pytest.mark.parametrize("case, kernel, side", sorted(BOUNDS))
def test_attention_bounds_of_the_cases(case, kernel, side):
    """``chip_smoke.attention_bound`` at ``msda_vs_source``'s cases, the
    yardstick of chip_smoke's B1 / B2 records and of the script's lines:
    each input read once and each output written once, over 3.35 TB/s,
    above the operations' time at the f32 rate."""
    shape = dict(msda_vs_source.cases("both"))[case]
    got = chip_smoke.attention_bound(kernel, side, **shape)
    assert (got["bytes"], round(got["bound_ms"], 3), got["bound_by"]) == (*BOUNDS[case, kernel, side], "bytes")


def test_msda_vs_source_reads_each_revisions_plan_arguments():
    """The script passes another source's C entry the plan arguments it
    declares: the parent revisions' ``vec, tile_y, tile_x``, this one's
    body and value planes too."""
    parent = ("int P, int radius, int vec, int tile_y, int tile_x, int sides, void* stream) {")
    src = "extern \"C\" int msda_windowed_bwd_sides_launch(const void* value, int B, " + parent
    assert msda_vs_source.entry_plan_args(src, "bwd") == ["vec", "tile_y", "tile_x"]
    this = (msda_vs_source.kernel_build.CSRC_DIR / "msda_windowed_bwd.cu").read_text()
    assert msda_vs_source.entry_plan_args(this, "bwd") == ["vec", "tile_y", "tile_x", "body", "levels"]
    this = (msda_vs_source.kernel_build.CSRC_DIR / "msda_windowed_fwd.cu").read_text()
    assert msda_vs_source.entry_plan_args(this, "fwd") == ["vec", "tile_y", "tile_x", "body"]
