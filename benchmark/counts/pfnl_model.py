"""PFNL's operations by layer, from its configuration and the input's shape.

Each layer is (operations of its forward, whether it has weights, whether
its input needs a gradient in training).  A forward is the sum of the
first; a training step adds, for each layer, a weight gradient of its
forward's size where it has weights and a data gradient of that size
where its input needs one.  The non-local attention's backward is one
product, P^T dy into g, since theta and phi are the input image.
Counted: convolutions and products (multiply-adds as 2); not counted:
activations, the bicubic resize (4 taps a pixel), softmax, the loss and
the training degradation.
"""


def layers(cfg, n: int, h: int, w: int):
    t, c, nb = cfg["num_frames"], cfg["mf"], cfg["num_blocks"]
    pos = (h // 2) * (w // 2)
    d = 4 * 3 * t
    hw = n * h * w
    out = [("nonlocal.g", 2.0 * n * pos * d * d, True, False),
           ("nonlocal.attention", 2.0 * n * pos * pos * (d + d), False, False),
           ("nonlocal.w", 2.0 * n * pos * d * d, True, True),
           ("conv0", 2.0 * hw * t * 25 * 3 * c, True, True)]
    for _ in range(nb):
        out += [("pfrb.conv1", 2.0 * hw * t * 9 * c * c, True, True),
                ("pfrb.fuse", 2.0 * hw * t * c * c, True, True),
                ("pfrb.conv2f", 2.0 * hw * t * 9 * c * c, True, True),
                ("pfrb.conv2b", 2.0 * hw * 9 * c * c, True, True)]
    out += [("merge1", 2.0 * hw * 9 * t * c * 48, True, True),
            ("merge2", 2.0 * 4 * hw * 9 * 12 * 12, True, True)]
    return out


def forward_ops(cfg, n: int, h: int, w: int) -> float:
    return sum(f for _, f, _, _ in layers(cfg, n, h, w))


def train_step_ops(cfg, n: int, h: int, w: int) -> float:
    """Forward and backward of one step on n windows of LR h x w."""
    total = 0.0
    t = cfg["num_frames"]
    for name, f, weights, data in layers(cfg, n, h, w):
        if name == "nonlocal.attention":
            pos = (h // 2) * (w // 2)
            total += f + 2.0 * n * pos * pos * (4 * 3 * t)
            continue
        total += f * (1 + int(weights) + int(data))
    return total
