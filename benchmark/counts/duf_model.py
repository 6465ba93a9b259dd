"""DUF's operations by layer, from its configuration and the input's shape
(convolutions and products, multiply-adds as 2; the dynamic filter's 25
taps a sub-pixel; not counted: BatchNorm, activations, softmax)."""


def forward_ops(cfg, n: int, h: int, w: int) -> float:
    t, g, scale = cfg["num_frames"], cfg["growth"], cfg["scale"]
    n_same, n_valid = cfg["same_blocks"], cfg["valid_blocks"]
    hw = n * h * w
    total = 2.0 * hw * t * 9 * 3 * 64
    f = 64
    planes = t
    for r in range(n_same + n_valid):
        out_planes = planes if r < n_same else planes - 2
        total += 2.0 * hw * (planes * f * f + out_planes * 27 * f * g)
        f, planes = f + g, out_planes
    rr = scale * scale
    total += 2.0 * hw * planes * 9 * f * 256
    total += 2.0 * hw * planes * (256 * 256 + 256 * 3 * rr + 256 * 512 + 512 * 25 * rr)
    total += 2.0 * hw * 25 * rr * 3
    return total
