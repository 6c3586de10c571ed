"""B3, the adjoint of bilinear sampling (the camera warp's backward, and
gather attention's value gradient): 12 operations a cotangent entry (4 taps
of 2 multiplies and an add). Bytes: the cotangent ``g [B, Q, C]`` and the
f32 coordinates ``sx, sy [B, Q]`` read once, the map's gradient
``[B, h, w, C]`` written once, in ``g``'s dtype."""

FLOP_PER_ENTRY = 12


def flops(g_numel: int) -> int:
    return FLOP_PER_ENTRY * g_numel


def nbytes(g_numel: int, out_numel: int, samples: int, itemsize: int) -> int:
    return (g_numel + out_numel) * itemsize + 2 * samples * 4
