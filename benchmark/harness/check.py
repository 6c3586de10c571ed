"""The comparison that decides ``correct``: what the timed path produced,
against the plain reference (``benchmark/reference``) run on the same
inputs and weights after the window.

Training (the first three steps of the window's own state, call and feed):

- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: the first gradient as the optimizer got it (Adam's first
  moment after step 1 over ``1 - beta1``), by the worst leaf: the gap of
  the two norms over the reference's norm of that leaf or of the median
  leaf, whichever is larger;
- ``grad_median_gap``: the same gaps at the median leaf. The L1 terms'
  gradient is a sign, which rounding flips where a prediction lies within
  rounding of its target, so the worst leaf swings from seed to seed; the
  median stays, and sees an error that reaches most leaves at a far
  smaller size than the worst leaf's limit lets pass;
- ``delta_gap``: the parameters' change over the three steps, by the worst
  leaf, each as above, leaving out leaves whose reference gradient is under
  a thousandth of the median leaf's (round-off moves them under Adam).

Serving (every answer the window finished, against the reference's answer
for its frame set):

- ``detection_gap``: for each of the program's candidates (x, y, score),
  the nearest reference cell by the largest of the position gaps in cells
  and the logit gap, taken at the worst candidate;
- ``rank_gap``: how far (in logits) a reference cell that no candidate
  matched lies above the lowest matched one: a candidate missing from the
  top;
- ``keep_gap``: candidates whose keep flag differs from greedy NMS run on
  the program's own candidates (exact).
"""

from __future__ import annotations

import contextlib
import statistics

import numpy as np
import torch

from benchmark.harness import reference
from benchmark.reference.decode import dense_decode, greedy_nms, top_candidates
from benchmark.reference.train import Trainer

TRAIN_NUMBERS = ("loss_gap", "grad_gap", "grad_median_gap", "delta_gap")
SERVE_NUMBERS = ("detection_gap", "rank_gap", "keep_gap")
BETA1_FIRST_STEP = 0.95  # OneCycle's max_momentum, Adam's beta1 on step 1
FROZEN_LEAF = 1e-3  # of the median leaf's gradient norm


@contextlib.contextmanager
def exact_f32():
    """TF32 off for the reference's products, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def moment_norms(optimizer, named_params) -> dict:
    """Each leaf's norm of Adam's first moment (0 where it has none), as
    device scalars."""
    out = {}
    for name, p in named_params:
        m = optimizer.state.get(p, {}).get("exp_avg")
        out[name] = m.float().norm() if m is not None else torch.zeros((), device=p.device)
    return out


def delta_norms(named_params, weights: dict) -> dict:
    return {name: (p.detach().float() - weights[name].float()).norm() for name, p in named_params}


def to_host(readings: dict) -> dict:
    return {k: ([float(x) for x in v] if isinstance(v, list) else {n: float(x) for n, x in v.items()})
            for k, v in readings.items()}


def reference_train(cfg, rig, weights, batches, dropout_seed, total_steps, device, precision="f32") -> dict:
    """The reference's readings over ``batches``: each step's loss, the
    first moments after step 1 and the change after the last step."""
    with exact_f32():
        trainer = Trainer(reference.of(cfg), cfg, rig, weights, total_steps, device, precision)
        gen = torch.Generator(device=device).manual_seed(dropout_seed)
        losses, moments = [], None
        for i, batch in enumerate(batches):
            losses.append(trainer.step(batch, gen)["loss"])
            if i == 0:
                moments = moment_norms(trainer.optimizer, trainer.model.named_parameters())
        delta = delta_norms(trainer.model.named_parameters(), weights)
    return to_host({"loss": losses, "moment": moments, "delta": delta})


def _leaf_gaps(prog: dict, ref: dict, names) -> list:
    median = statistics.median(ref[n] for n in ref)
    return [abs(prog[n] - ref[n]) / max(ref[n], median) for n in names]


def train_numbers(prog: dict, ref: dict) -> dict:
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"]))
    grad_ref = {n: v / (1 - BETA1_FIRST_STEP) for n, v in ref["moment"].items()}
    grad_prog = {n: v / (1 - BETA1_FIRST_STEP) for n, v in prog["moment"].items()}
    median = statistics.median(grad_ref.values())
    moving = [n for n, g in grad_ref.items() if g >= FROZEN_LEAF * median]
    grad = _leaf_gaps(grad_prog, grad_ref, grad_ref)
    return {"loss_gap": loss, "grad_gap": max(grad), "grad_median_gap": statistics.median(grad),
            "delta_gap": max(_leaf_gaps(prog["delta"], ref["delta"], moving), default=0.0)}


def reference_answers(cfg, rig, weights, pool, device, precision="f32") -> dict:
    """For each pool entry, the reference's dense decode ``(xy [HW, 2],
    logit [HW])`` and its own answer ``(candidates [K, 3], keep [K])``."""
    out = {}
    ref = reference.of(cfg)
    with exact_f32(), torch.no_grad():
        model = ref.MVDeTr(cfg, rig, precision).to(device)
        model.load_state_dict(weights, strict=True)
        model.eval()
        for i, batch in enumerate(pool):
            warp = ref.warp_coords(cfg, rig, batch["affine_mats"]).to(device)
            (hm, off), _ = model(torch.from_numpy(batch["imgs"]).to(device), warp)
            xy, logit = dense_decode(hm[:1], off[:1], cfg["world_reduce"])
            cand = top_candidates(xy, logit, cfg["num_candidates"]).cpu().numpy().astype(np.float32)
            out[i] = (xy, logit, cand, greedy_nms(cand[:, :2], cand[:, 2], cfg["nms_dist"]))
    return out


def _logit(score: torch.Tensor) -> torch.Tensor:
    s = score.double().clamp(1e-12, 1 - 1e-12)
    return torch.log(s) - torch.log1p(-s)


def answer_gaps(cand: np.ndarray, xy: torch.Tensor, logit: torch.Tensor, reduce: int, chunk: int = 64) -> tuple:
    """``(detection gap, rank gap)`` of one answer's candidates ``[K, 3]``
    against the reference's dense decode."""
    c = torch.from_numpy(np.asarray(cand, dtype=np.float64)).to(xy.device)
    cells = torch.cat([xy / reduce, logit[:, None]], dim=1)
    probe = torch.cat([c[:, :2] / reduce, _logit(c[:, 2])[:, None]], dim=1)
    worst, matched = 0.0, []
    for i in range(0, len(probe), chunk):
        res = (probe[i:i + chunk, None, :] - cells[None]).abs().amax(-1)
        best, idx = res.min(dim=1)
        worst = max(worst, float(best.max()))
        matched.append(idx)
    matched = torch.cat(matched)
    mask = torch.zeros(len(logit), dtype=torch.bool, device=logit.device)
    mask[matched] = True
    rank = float((logit[~mask].max() - logit[mask].min()).clamp(min=0.0)) if bool((~mask).any()) else 0.0
    return worst, rank


def serve_numbers(answers: list, refs: dict, cfg: dict) -> dict:
    """``answers``: ``(pool index, candidates [K, 3], keep [K])`` of every
    finished request; the same answer for a frame set is judged once."""
    seen = {}
    for idx, cand, keep in answers:
        seen.setdefault((idx, cand.tobytes(), keep.tobytes()), (idx, cand, keep))
    det = rank = 0.0
    keep_gap = 0
    for idx, cand, keep in seen.values():
        xy, logit = refs[idx][:2]
        d, r = answer_gaps(cand, xy, logit, cfg["world_reduce"])
        det, rank = max(det, d), max(rank, r)
        keep_gap += int((greedy_nms(cand[:, :2], cand[:, 2], cfg["nms_dist"]) != keep).sum())
    return {"detection_gap": det, "rank_gap": rank, "keep_gap": float(keep_gap)}


def judge(numbers: dict, limits: dict | None) -> tuple:
    """``(correct, checks)``: each number beside its limit; a number with
    no limit, or not finite, fails."""
    checks, ok = {}, True
    for name, value in numbers.items():
        limit = None if limits is None else limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        ok = ok and limit is not None and np.isfinite(value) and value <= limit
    return ok, checks
