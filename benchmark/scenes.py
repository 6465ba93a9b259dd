"""Seeded synthetic video: scenes with motion, made on the device.

A scene is two layers.  The background is smooth noise at three scales
with a global pan; the foreground is a set of coloured rectangles with
their own drift, over it where their mask is set.  Every frame samples
both layers bilinearly at its sub-pixel offset, so edges move across the
pixel grid from frame to frame.  The same seed gives the same frames on
the same device.
"""

import torch
import torch.nn.functional as F

RECTS = 8


def make(count: int, frames: int, h: int, w: int, seed: int, device,
         speed: float = 1.5) -> torch.Tensor:
    """-> uint8 [count, frames, h, w, 3] on the device."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    margin = int(speed * frames) + 2
    ch, cw = h + 2 * margin, w + 2 * margin
    bg = torch.zeros(count, 3, ch, cw, device=device)
    for cell, amp in ((64, 0.6), (16, 0.3), (4, 0.15)):
        grid = rand(count, 3, ch // cell + 2, cw // cell + 2)
        bg += amp * F.interpolate(grid, size=(ch, cw), mode="bicubic", align_corners=False)
    yy = torch.arange(ch, device=device).view(1, 1, ch, 1).float()
    xx = torch.arange(cw, device=device).view(1, 1, 1, cw).float()
    y0, x0 = rand(count, RECTS, 1, 1) * ch, rand(count, RECTS, 1, 1) * cw
    rh, rw = 4 + rand(count, RECTS, 1, 1) * ch / 4, 4 + rand(count, RECTS, 1, 1) * cw / 4
    inside = ((yy >= y0) & (yy < y0 + rh) & (xx >= x0) & (xx < x0 + rw)).float()  # [c,R,ch,cw]
    colour = rand(count, RECTS, 3)
    # later rectangles over earlier ones
    alpha = torch.zeros(count, 1, ch, cw, device=device)
    fg = torch.zeros(count, 3, ch, cw, device=device)
    for r in range(RECTS):
        m = inside[:, r:r + 1]
        fg = fg * (1 - m) + m * colour[:, r, :, None, None]
        alpha = torch.maximum(alpha, m)

    vel = (rand(count, 2, 2) * 2 - 1) * speed          # [scene, layer, (dy, dx)] px a frame
    t = torch.arange(frames, device=device).float()
    layers = (torch.cat([bg, torch.ones_like(alpha)], 1), torch.cat([fg, alpha], 1))
    scenes = []
    for s in range(count):
        back, front = (
            F.grid_sample(img[s:s + 1].expand(frames, 4, ch, cw), _grid(vel[s, k], t, margin, h, w,
                                                                        ch, cw),
                          mode="bilinear", align_corners=True)
            for k, img in enumerate(layers))
        a = front[:, 3:4]
        scenes.append((back[:, :3] * (1 - a) + front[:, :3] * a).permute(0, 2, 3, 1))
    return torch.round(torch.stack(scenes).clamp(0, 1) * 255).to(torch.uint8)


def _grid(v, t, margin, h, w, ch, cw):
    """[frames, h, w, 2] sampling grid of a layer drifting v (dy, dx) a frame."""
    device = t.device
    gy = (margin + v[0] * t[:, None] + torch.arange(h, device=device)) * 2 / (ch - 1) - 1
    gx = (margin + v[1] * t[:, None] + torch.arange(w, device=device)) * 2 / (cw - 1) - 1
    return torch.stack(torch.broadcast_tensors(gx[:, None, :], gy[:, :, None]), -1)
