"""The numbers of one seed, without a measured window: the sound program's
(or one with a fault planted, :mod:`benchmark.harness.faults`), and the
control's, the reference in float8 put in the program's place. These set
the limits (``benchmark/control.py``) and the tests hold them."""

from __future__ import annotations

from benchmark.harness import cells, check, inputs


def program_numbers(cfg: dict, traffic: dict, seed: int, device, seconds: float = 3.0) -> dict:
    """Training: the first steps of a train state built as a run builds it.
    Serving: the answers of ``seconds`` of the cell's traffic."""
    if traffic["kind"] == "train":
        run = cells.TrainRun(cfg, traffic, seed, device)
        prog = check.to_host(run.first_steps())
        run.close()
        ref = check.reference_train(cfg, run.rig, run.weights, run.pool[:traffic["warmup_steps"]], run.seeds.dropout,
                                    cells.total_steps(cfg, traffic), device)
        return check.train_numbers(prog, ref)
    run = cells.ServeRun(cfg, traffic, seed, device)
    run.serve(inputs.schedule(traffic, run.seeds.schedule, seconds), keep_answers=True)
    answers, rest = run.answers, (run.rig, run.weights, run.pool)
    del run
    cells._free(device)
    return check.serve_numbers(answers, check.reference_answers(cfg, *rest, device), cfg)


def control_numbers(cfg: dict, traffic: dict, seed: int, device, precision: str = "fp8") -> dict:
    """The reference in ``precision`` (float8: the control) judged as the
    program's output is."""
    rig = inputs.rig_of(cfg)
    seeds = inputs.Seeds(seed)
    weights = inputs.make_weights(cfg, rig, seeds.weights, device)
    if traffic["kind"] == "train":
        pool = inputs.train_pool(cfg, traffic, rig, seeds, device)[:traffic["warmup_steps"]]
        args = (cfg, rig, weights, pool, seeds.dropout, cells.total_steps(cfg, traffic), device)
        return check.train_numbers(check.reference_train(*args, precision=precision), check.reference_train(*args))
    calibration = inputs.random_frames(cfg, 1, seeds.data, device, pin=False)
    inputs.calibrate_running_stats(cfg, rig, weights, calibration, device)
    pool = inputs.serve_pool(cfg, traffic, seeds, device)
    low = check.reference_answers(cfg, rig, weights, pool, device, precision=precision)
    answers = [(i, low[i][2], low[i][3]) for i in low]
    return check.serve_numbers(answers, check.reference_answers(cfg, rig, weights, pool, device), cfg)
