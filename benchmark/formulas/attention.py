"""The fusion's attention module (``MSDeformAttn``: value, offset and
weight projections, the sampling, the output projection) as one piece of
work: the least time of a layer, forward (and backward in training), with
the module's inputs (query and tokens, bf16) and weights read once and its
outputs written once, and its products at the tensor cores' peak and the
sampling's operations at the f32 peak (the per-mode file gives those)."""

from benchmark.formulas.peaks import least_seconds


def shape_of(cfg: dict, batch: int) -> dict:
    """The attention's sizes in a configuration: levels are the cameras,
    queries their copies of the stride-2 BEV grid."""
    hs, ws = ((s // cfg["world_reduce"] - 1) // 2 + 1 for s in cfg["worldgrid_shape"])
    n = cfg["num_cam"]
    return {"b": batch, "l": n, "q": n * hs * ws, "s": n * hs * ws, "c": cfg["hidden_dim"], "m": cfg["nhead"],
            "d": cfg["head_dim"], "p": cfg["n_points"], "layers": cfg["enc_layers"]}


def samples(sh: dict) -> int:
    return sh["b"] * sh["q"] * sh["m"] * sh["l"] * sh["p"]


def module_work(sh: dict, train: bool) -> tuple:
    """``(bytes, tensor-core FLOPs)`` of one layer's projections and I/O."""
    b, q, s, c, mlp = sh["b"], sh["q"], sh["s"], sh["c"], sh["m"] * sh["l"] * sh["p"]
    params = c * c * 2 + c * mlp * 3 + 2 * c + mlp * 3
    products = 2 * b * (s * c * c + q * c * 2 * mlp + q * c * mlp + q * c * c)
    io = 2 * (b * q * c + b * s * c + params) + 2 * b * q * c
    if train:  # the cotangent in, the inputs and weights again; their gradients out (weights' in f32)
        io += 2 * (b * q * c + b * q * c + b * s * c + params) + 2 * (b * q * c + b * s * c) + 4 * params
        products *= 3
    return io, products


def least_step_seconds(sh: dict, train: bool, sampling_flops) -> float:
    """Least time of all layers: ``sampling_flops(sh, train)`` is the mode's
    f32 operations of one layer's sampling."""
    nbytes, products = module_work(sh, train)
    return sh["layers"] * least_seconds(nbytes, products, sampling_flops(sh, train))
