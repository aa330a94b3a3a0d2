"""Plain PyTorch reference of the NoPe-NeRF training step, test-time pose
step and image render, in float32 with TF32 off (a frozen copy of the plain
code of the stock configurations' branches, written against nothing of the
program).

What it covers: the per-frame SE(3) poses (Rodrigues with the small-angle
series), the depth scale/shift, ray set-up (uniform samples with the
stratified jitter, or NDC rays), the positional encodings, the 8x256 skip
MLP with its density and view-dependent rgb heads, alpha compositing
(occupancy or ``dist_alpha``), the rgb, depth, banded Chamfer (pc) and
reprojection (rgb_s) losses of the reference pair, autograd, and Adam.

``mm`` is the matrix product of the MLP: :func:`mm_f32` for the reference,
:func:`mm_fp8` for the lower-precision control, float8 as FP8 training
runs it (the hybrid format): operands rounded to e4m3 in the forward, the
backward's incoming gradient to e5m2, each tensor under one scale (its
largest magnitude to the format's largest value), f32 accumulation.
"""
from __future__ import annotations

import contextlib
import math

import torch

EPS = 1e-6
FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}
BAND_TILE = 1024   # rows of Y per band tile, the band mode's definition
BAND_GROUP = 1024  # queries per group sharing one band start
SENTINEL = 1e5


@contextlib.contextmanager
def full_f32():
    """Matrix products and convolutions in full float32 (TF32 off)."""
    m, c = torch.backends.cuda.matmul, torch.backends.cudnn
    prev = m.allow_tf32, c.allow_tf32
    m.allow_tf32 = c.allow_tf32 = False
    try:
        yield
    finally:
        m.allow_tf32, c.allow_tf32 = prev


def mm_f32(x, w):
    return x @ w


def _fp8(x, fmt=torch.float8_e4m3fn):
    """x rounded to the float8 format ``fmt`` under one per-tensor scale."""
    scale = torch.clamp_min(x.detach().abs().amax(), 1e-30) / FP8_MAX[fmt]
    return (x / scale).to(fmt).to(x.dtype) * scale


class _MatmulFP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        xq, wq = _fp8(x), _fp8(w)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = _fp8(g, torch.float8_e5m2)
        return gq @ wq.t(), xq.t() @ gq


def mm_fp8(x, w):
    return _MatmulFP8.apply(x, w)


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


def skew(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def rodrigues(r):
    """exp of the axis-angle r (..., 3) -> (..., 3, 3); below 1e-4 rad the
    coefficients come from their series."""
    k = skew(r)
    sq = torch.sum(r * r, -1)[..., None, None]
    small = sq < 1e-8
    sq_safe = torch.where(small, torch.ones_like(sq), sq)
    n = torch.sqrt(sq_safe)
    a = torch.where(small, 1.0 - sq / 6.0, torch.sin(n) / n)
    b = torch.where(small, 0.5 - sq / 24.0, (1.0 - torch.cos(n)) / sq_safe)
    return torch.eye(3, dtype=r.dtype, device=r.device) + a * k + b * (k @ k)


def c2w_of(r, t):
    """[[exp(r), t], [0, 0, 0, 1]] for one frame's r, t (3,)."""
    top = torch.cat([rodrigues(r), t[:, None]], 1)
    return torch.cat([top, torch.eye(4, device=r.device)[3:]], 0)


def rigid_inverse(m):
    rt = m[:3, :3].t()
    top = torch.cat([rt, -(rt @ m[:3, 3:])], 1)
    return torch.cat([top, torch.eye(4, device=m.device)[3:]], 0)


def pixel_coords(idx, h, w):
    """[-1, 1] coordinates of flat row-major pixel indices."""
    row, col = torch.div(idx, w, rounding_mode="floor"), idx % w
    return torch.stack([2.0 * col.float() / (w - 1) - 1.0,
                        2.0 * row.float() / (h - 1) - 1.0], -1)


def grid_coords(h, w, device):
    return pixel_coords(torch.arange(h * w, device=device), h, w)


def backproject(pixels, depth, transform):
    """World points (N, 3) of pixels at depths through the 4x4 pixel ->
    world transform."""
    hom = torch.stack([pixels[:, 0] * depth, pixels[:, 1] * depth, depth,
                       torch.ones_like(depth)], -1)
    return (hom @ transform.t())[:, :3]


def pixel_to_world(camera, world, scale):
    inv = torch.linalg.inv
    return (inv(scale) @ inv(world)) @ inv(camera)


def project(points, camera):
    """Camera-frame points -> ([-1, 1] xy, inside the image)."""
    ones = torch.ones_like(points[:, :1])
    xy = torch.cat([points, ones], -1) @ camera.t()
    xy = xy[:, :2] / xy[:, 2:3]
    return xy, torch.amax(xy.abs(), -1) <= 1.0


def ndc_rays(focal, near, o, d):
    t = -(near + o[..., 2]) / d[..., 2]
    o = o + t[..., None] * d
    ox, oy = o[..., 0] / o[..., 2], o[..., 1] / o[..., 2]
    o2 = 1.0 + 2.0 * near / o[..., 2]
    dirs = torch.stack([-focal[0] * (d[..., 0] / d[..., 2] - ox),
                        -focal[1] * (d[..., 1] / d[..., 2] - oy),
                        1.0 - o2], -1)
    return torch.stack([-focal[0] * ox, -focal[1] * oy, o2], -1), dirs


def rays(pixels, depth, camera, world, scale, rcfg, noise=None):
    """One frame's rays: origins, directions of the samples, view
    directions, z (N, S), the prior's distance d_gt, its validity and the
    ray norms."""
    n, s = pixels.shape[0], rcfg["num_points"]
    tr = pixel_to_world(camera, world, scale)
    cam = tr[:3, 3]
    diff = backproject(pixels, depth, tr) - cam
    d_sq = torch.sum(diff * diff, -1)
    d_gt = torch.sqrt(torch.clamp_min(d_sq, 1e-24))
    vec = backproject(pixels, torch.ones_like(depth), tr) - cam
    norm = torch.sqrt(torch.clamp_min(torch.sum(vec * vec, -1), 1e-24))
    if rcfg["normalise_ray"]:
        vec = vec / norm[:, None]
    else:
        d_gt = d_gt / norm
    valid = (torch.isfinite(d_gt) & (d_sq > 0)).float()
    z = torch.linspace(0.0, 1.0, s, device=pixels.device).expand(n, s)
    origins = cam[None].expand(n, 3)
    if rcfg["sample_option"] == "ndc":
        origins, along = ndc_rays(torch.stack([camera[0, 0], camera[1, 1]]),
                                  1.0, origins, vec)
    else:
        near, far = rcfg["depth_range"]
        z = near * (1.0 - z) + far * z
        if noise is not None:
            mid = 0.5 * (z[:, 1:] + z[:, :-1])
            hi = torch.cat([mid, z[:, -1:]], -1)
            lo = torch.cat([z[:, :1], mid], -1)
            z = lo + (hi - lo) * noise
        along = vec
    return {"origins": origins, "along": along, "view": -vec, "z": z,
            "d_gt": d_gt, "valid": valid, "norm": norm}


# ---------------------------------------------------------------------------
# the field and the renderer
# ---------------------------------------------------------------------------


def encode(x, levels):
    freqs = 2.0 ** torch.arange(levels, dtype=x.dtype, device=x.device)
    xb = x[..., None, :] * freqs[:, None]
    enc = torch.stack([torch.sin(xb), torch.cos(xb)], -2)
    return torch.cat([x, enc.reshape(x.shape[:-1] + (-1,))], -1)


def field(p, pts, view, mcfg, mm):
    """Raw density (M,) and raw rgb (M, 3) at points pts with view
    directions ``view`` (M, 3)."""
    enc = encode(pts, mcfg["pos_enc_levels"])
    h = enc
    for i in range(4):
        h = torch.relu(mm(h, p[f"trunk0_{i}"]["w"]) + p[f"trunk0_{i}"]["b"])
    h = torch.cat([h, enc], -1)
    for i in range(4):
        h = torch.relu(mm(h, p[f"trunk1_{i}"]["w"]) + p[f"trunk1_{i}"]["b"])
    sigma = (mm(h, p["fc_density"]["w"]) + p["fc_density"]["b"])[:, 0]
    feat = mm(h, p["fc_feature"]["w"]) + p["fc_feature"]["b"]
    x = torch.cat([feat, encode(view, mcfg["dir_enc_levels"])], -1)
    hr = torch.relu(mm(x, p["rgb_layer"]["w"]) + p["rgb_layer"]["b"])
    return sigma, mm(hr, p["fc_rgb"]["w"]) + p["fc_rgb"]["b"]


def softplus(x):
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def render(p, ray, mcfg, rcfg, mm):
    """Composite the field along the rays: (rgb (N, 3), expected distance
    (N,))."""
    n, s = ray["z"].shape
    z = ray["z"]
    pts = ray["origins"][:, None] + ray["along"][:, None] * z[..., None]
    view = ray["view"][:, None].expand(n, s, 3)
    sigma, raw = field(p, pts.reshape(-1, 3), view.reshape(-1, 3), mcfg, mm)
    density = softplus(sigma).reshape(n, s)
    if rcfg["dist_alpha"]:
        delta = torch.cat([z[:, 1:] - z[:, :-1],
                           torch.full_like(z[:, :1], 1e10)], -1)
        alpha = 1.0 - torch.exp(-density * delta)
        alpha = torch.cat([alpha[:, :-1], torch.ones_like(alpha[:, -1:])], 1)
    else:
        alpha = 1.0 - torch.exp(-density)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]),
                                     1.0 - alpha + EPS], 1), 1)[:, :-1]
    w = alpha * trans
    rgb = torch.sum(w[..., None] * torch.sigmoid(raw).reshape(n, s, 3), 1)
    if rcfg["white_background"]:
        rgb = rgb + (1.0 - torch.sum(w, 1))[:, None]
    return rgb, torch.sum(w * z, 1)


def render_pixels(p, pix_idx, hw, camera, world, mcfg, rcfg, mm,
                  chunk=4096):
    """The eval render of flat pixel indices of an (h, w) image: depth
    prior 1, no jitter, the distance divided by the ray norm with
    ``normalise_ray``. Returns (rgb (n, 3), depth (n,)), chunk by chunk,
    without autograd."""
    eye = torch.eye(4, device=camera.device)
    rgbs, depths = [], []
    with torch.no_grad(), full_f32():
        for i in range(0, pix_idx.shape[0], chunk):
            pix = pixel_coords(pix_idx[i:i + chunk], *hw)
            ray = rays(pix, torch.ones(pix.shape[0], device=pix.device),
                       camera, world, eye, rcfg)
            rgb, dist = render(p, ray, mcfg, rcfg, mm)
            if rcfg["normalise_ray"]:
                dist = dist / ray["norm"]
            rgbs.append(rgb)
            depths.append(dist)
    return torch.cat(rgbs), torch.cat(depths)


# ---------------------------------------------------------------------------
# image resampling of the reference pair
# ---------------------------------------------------------------------------


def nearest_src(n_out, n_in, device):
    scale = torch.tensor(n_in / n_out, dtype=torch.float32)
    return torch.floor(torch.arange(n_out, dtype=torch.float32)
                       * scale).long().to(device)


def resize_nearest(img, hw):
    h, w = hw
    return img.index_select(0, nearest_src(h, img.shape[0], img.device)) \
        .index_select(1, nearest_src(w, img.shape[1], img.device))


def resize_bilinear(img, hw):
    H, W = img.shape[:2]
    h, w = hw
    dev = img.device
    fy = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) * (H / h) \
        - 0.5
    fx = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) * (W / w) \
        - 0.5
    y0f, x0f = torch.floor(fy), torch.floor(fx)
    wy1 = torch.clamp(fy - y0f, 0.0, 1.0)[:, None, None]
    wx1 = torch.clamp(fx - x0f, 0.0, 1.0)[None, :, None]
    y0 = torch.clamp(y0f.long(), 0, H - 1)
    x0 = torch.clamp(x0f.long(), 0, W - 1)
    y1, x1 = torch.clamp(y0 + 1, 0, H - 1), torch.clamp(x0 + 1, 0, W - 1)
    return (img[y0[:, None], x0[None]] * (1 - wy1) * (1 - wx1)
            + img[y0[:, None], x1[None]] * (1 - wy1) * wx1
            + img[y1[:, None], x0[None]] * wy1 * (1 - wx1)
            + img[y1[:, None], x1[None]] * wy1 * wx1)


def sample_bilinear(img, xy):
    """img (H, W, C) at [-1, 1] xy with corners aligned; taps outside
    contribute 0."""
    H, W, _ = img.shape
    fx = (xy[:, 0] + 1.0) / 2.0 * (W - 1)
    fy = (xy[:, 1] + 1.0) / 2.0 * (H - 1)
    x0f, y0f = torch.floor(fx), torch.floor(fy)
    out = 0.0
    for xi, wx in ((x0f.long(), 1.0 - (fx - x0f)), (x0f.long() + 1, fx - x0f)):
        for yi, wy in ((y0f.long(), 1.0 - (fy - y0f)),
                       (y0f.long() + 1, fy - y0f)):
            inb = ((xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)).float()
            v = img[torch.clamp(yi, 0, H - 1), torch.clamp(xi, 0, W - 1)]
            out = out + v * (wx * wy * inb)[:, None]
    return out


# ---------------------------------------------------------------------------
# the banded Chamfer loss
# ---------------------------------------------------------------------------


def band_starts(rows, n_y, width, k):
    """Per group of BAND_GROUP queries, the first band tile: the median of
    the group's finite projected rows, in tiles, less k // 2, clamped."""
    s = rows.shape[0]
    sp = -(-s // BAND_GROUP) * BAND_GROUP
    rows = torch.cat([rows, torch.full((sp - s,), float("nan"),
                                       device=rows.device)])
    groups = rows.reshape(-1, BAND_GROUP)
    fin = torch.isfinite(groups)
    srt = torch.sort(torch.where(fin, groups, torch.full_like(groups, 3.4e38)),
                     1).values
    nf = fin.sum(1)
    med = torch.gather(srt, 1, torch.clamp((nf - 1) // 2, 0,
                                           BAND_GROUP - 1)[:, None])[:, 0]
    med = torch.where(nf > 0, med, torch.zeros_like(med))
    n_tiles = -(-n_y // BAND_TILE)
    start = torch.round(med * width / BAND_TILE).to(torch.int32) - k // 2
    return torch.clamp(start, 0, max(n_tiles - k, 0))


def band_tiles(grid_hw, band_rows, pinned=None):
    """Tiles per band: ``pinned``, else max(2, round(band_rows * width /
    BAND_TILE))."""
    return pinned or max(2, round(band_rows * grid_hw[1] / BAND_TILE))


def band_nearest(X, Y, starts, k):
    """For each query of X, the first nearest row of Y among its group's
    band of k tiles, by the direct ((dx^2 + dy^2) + dz^2)."""
    X, Y = X.detach(), Y.detach()
    s, d = X.shape[0], Y.shape[0]
    n_tiles = -(-d // BAND_TILE)
    k = min(k, n_tiles)
    sp = -(-s // BAND_GROUP) * BAND_GROUP
    Xp = torch.cat([X, torch.full((sp - s, 3), SENTINEL, device=X.device)])
    Yp = torch.cat([Y, torch.full((n_tiles * BAND_TILE - d, 3), -SENTINEL,
                                  device=Y.device)])
    out = []
    for g, st in enumerate(starts.tolist()):
        st = min(max(st, 0), max(n_tiles - k, 0)) * BAND_TILE
        xb = Xp[g * BAND_GROUP:(g + 1) * BAND_GROUP]
        dd = (xb[:, None, :] - Yp[None, st:st + k * BAND_TILE, :]) ** 2
        out.append(torch.argmin((dd[..., 0] + dd[..., 1]) + dd[..., 2], 1)
                   + st)
    return torch.cat(out)[:s]


def band_pairs(starts, n_x, n_y, k):
    """The pairs the band definition examines: each query against the real
    rows of its group's band."""
    n_tiles = -(-n_y // BAND_TILE)
    k = min(k, n_tiles)
    total = 0
    for g, st in enumerate(starts.tolist()):
        st = min(max(st, 0), max(n_tiles - k, 0)) * BAND_TILE
        queries = min(BAND_GROUP, n_x - g * BAND_GROUP)
        total += queries * (min(st + k * BAND_TILE, n_y) - st)
    return total


def safe_norm(v):
    return torch.sqrt(torch.clamp_min(torch.sum(v * v, -1), 1e-24))


def chamfer(X, Y, starts_x, starts_y, k):
    ix = band_nearest(X, Y, starts_x, k)
    iy = band_nearest(Y, X, starts_y, k)
    return safe_norm(X - Y[ix]).mean() + safe_norm(Y - X[iy]).mean()


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------


def scale_shift(dist, i, n_cams, dcfg):
    scale = torch.clamp_min(dist["scales"][i], 0.01)
    if dcfg["fix_scaleN"] and i == n_cams - 1:
        scale = torch.ones_like(scale)
    return scale, dist["shifts"][i]


def train_loss(params, frames, i, ref, cfg, weights, w_l1, w_l2, noise_gen,
               mm, keep_rays=None):
    """The loss of one step on frame ``i`` paired with frame ``ref`` (host
    ints), its rays and jitter drawn from ``noise_gen`` as the step draws
    them. ``frames`` holds imgs (N, H, W, 3), dpts (N, H, W), the pc_ratio
    pyramid imgs_small / dpts_small and K. ``keep_rays`` (a planted fault
    for the comparison's own test) takes the rgb and depth terms over the
    first ``keep_rays`` rays only. Returns (loss, terms)."""
    tcfg, rcfg, mcfg = cfg["training"], cfg["rendering"], cfg["model"]
    imgs, dpts, K = frames["imgs"], frames["dpts"], frames["K"]
    n_cams, H, W = imgs.shape[:3]
    dev = imgs.device
    pose, dist = params["pose"], params["distortion"]
    c2w = c2w_of(pose["r"][i], pose["t"][i])
    world = rigid_inverse(c2w)
    sc, sh = scale_shift(dist, i, n_cams, cfg["distortion"])

    n = tcfg["n_training_points"]
    idx = torch.randint(0, H * W, (n,), generator=noise_gen, device=dev)
    rgb_gt = imgs[i].reshape(-1, 3)[idx]
    prior = dpts[i].reshape(-1)[idx] * sc + sh
    noise = None
    if rcfg["sample_option"] != "ndc" and cfg["tpu"]["render_add_noise"]:
        noise = torch.rand((n, rcfg["num_points"]), generator=noise_gen,
                           device=dev)
    ray = rays(pixel_coords(idx, H, W), prior, K, world,
               torch.eye(4, device=dev), rcfg, noise)
    rgb, depth = render(params["nerf"], ray, mcfg, rcfg, mm)
    depth_gt = ray["d_gt"]
    if rcfg["sample_option"] == "ndc":
        depth_gt = 1.0 - 1.0 / torch.where(depth_gt == 0,
                                           torch.ones_like(depth_gt), depth_gt)
        depth_gt = torch.where(ray["valid"] > 0, depth_gt,
                               torch.zeros_like(depth_gt))

    # the reference pair, ordered (earlier = 1, later = 2)
    c2w_ref = c2w_of(pose["r"][ref], pose["t"][ref]).detach()
    sc_ref, sh_ref = (v.detach() for v in scale_shift(dist, ref, n_cams,
                                                       cfg["distortion"]))
    swap = i >= n_cams - 1
    rel = world @ c2w_ref if swap else rigid_inverse(c2w_ref) @ c2w
    R, t = rel[:3, :3], rel[:3, 3]
    hs, ws = int(H / tcfg["pc_ratio"]), int(W / tcfg["pc_ratio"])
    small = frames["dpts_small"]
    d1 = (small[ref] * sc_ref + sh_ref) if swap else (small[i] * sc + sh)
    d2 = (small[i] * sc + sh) if swap else (small[ref] * sc_ref + sh_ref)
    scale2 = sc if swap else sc_ref
    nl = tcfg["nearest_limit"]
    grid = grid_coords(hs, ws, dev)
    eye = torch.eye(4, device=dev)
    to_world = pixel_to_world(K, eye, eye)
    pc1 = backproject(grid, torch.clamp_min(d1, nl).reshape(-1), to_world)
    pc2 = backproject(grid, torch.clamp_min(d2, nl).reshape(-1), to_world)

    ims = frames["imgs_small"]
    img1, img2 = (ims[ref], ims[i]) if swap else (ims[i], ims[ref])
    rot = pc1 @ R.t() + t
    rot = torch.where(-rot[:, 2:] < nl, torch.full_like(rot, nl), rot)
    xy, inside = project(rot, K)
    proj = sample_bilinear(img2, xy).reshape(hs, ws, 3)
    diff = torch.clamp(torch.abs(img1 - proj), 0.0, 1.0)
    mask = inside.float().reshape(hs, ws, 1).expand(diff.shape)
    rgb_s = torch.sum(diff * mask) / torch.clamp_min(torch.sum(mask), 1.0)

    pc1 = pc1 @ R.t() + t
    k = band_tiles((hs, ws), cfg["tpu"]["chamfer_band_rows"],
                   cfg["tpu"].get("chamfer_band_tiles"))

    def starts(pts):
        xy_, _ = project(pts.detach(), K)
        return band_starts((xy_[:, 1] + 1.0) * 0.5 * (hs - 1), hs * ws, ws,
                           k)

    sx, sy = starts(pc1), starts((pc2 - t) @ R)
    if tcfg["scale_pcs"]:
        pc1, pc2 = pc1 / scale2, pc2 / scale2
    pc = chamfer(pc1, pc2, sx, sy, k)

    v = ray["valid"]
    if keep_rays is not None:
        n = keep_rays
        rgb, rgb_gt, depth, depth_gt, v = (a[:n] for a in (rgb, rgb_gt, depth,
                                                           depth_gt, v))
    d = rgb - rgb_gt
    rgb_loss = w_l1 * (torch.sum(d.abs()) / n) + w_l2 * (torch.sum(d * d) / n)
    depth_loss = torch.sum(torch.abs(depth - depth_gt) * v) / torch.clamp_min(
        torch.sum(v), 1.0)
    loss = (weights["rgb_weight"] * rgb_loss
            + weights["depth_weight"] * depth_loss
            + weights["pc_weight"] * pc + weights["rgb_s_weight"] * rgb_s)
    return loss, {"rgb": rgb_loss, "depth": depth_loss, "pc": pc,
                  "rgb_s": rgb_s}


class Adam:
    """Adam (betas 0.9 / 0.999, eps 1e-8) over named leaves, each with its
    group's learning rate."""

    def __init__(self, leaves, lrs):
        self.leaves, self.lrs = leaves, lrs
        self.m = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.v = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.n = 0

    def step(self, grads):
        self.n += 1
        b1, b2 = 1.0 - 0.9 ** self.n, 1.0 - 0.999 ** self.n
        with torch.no_grad():
            for k, p in self.leaves.items():
                g = grads[k]
                self.m[k].mul_(0.9).add_(g, alpha=0.1)
                self.v[k].mul_(0.999).addcmul_(g, g, value=0.001)
                denom = self.v[k].sqrt() / math.sqrt(b2) + 1e-8
                p.sub_(self.lrs[k] / b1 * self.m[k] / denom)


def leaves_of(params):
    """{group/layer/key: tensor} of a nested parameter dict."""
    out = {}
    for g, grp in params.items():
        for k, v in grp.items():
            if isinstance(v, dict):
                for kk, t in v.items():
                    out[f"{g}/{k}/{kk}"] = t
            else:
                out[f"{g}/{k}"] = v
    return out


def train_steps(params, frames, steps, cfg, weights, w_l1, w_l2, lrs,
                noise_gen, mm, keep_rays=None, grad_scale=None):
    """Run len(steps) training steps of (frame, reference frame) from
    ``params`` (copied). Returns (each step's loss and its terms {"loss",
    "rgb", "depth", "pc", "rgb_s"}, the first step's gradients as Adam
    gets them, the parameters after the last step), gradients and
    parameters as {leaf name: tensor}. ``grad_scale`` (leaf name, factor),
    a planted fault for setting limits, scales that leaf's gradient."""
    params = {g: {k: ({kk: t.detach().clone().requires_grad_(True)
                       for kk, t in v.items()} if isinstance(v, dict)
                      else v.detach().clone().requires_grad_(True))
                  for k, v in grp.items()} for g, grp in params.items()}
    leaves = leaves_of(params)
    opt = Adam(leaves, {k: lrs[k.split("/")[0]] for k in leaves})
    losses, first = [], None
    with full_f32():
        for i, ref in steps:
            loss, terms = train_loss(params, frames, i, ref, cfg, weights,
                                     w_l1, w_l2, noise_gen, mm, keep_rays)
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
            grads = {k: torch.zeros_like(v) if g is None else g
                     for (k, v), g in zip(leaves.items(), grads)}
            if grad_scale is not None:
                grads[grad_scale[0]] = grads[grad_scale[0]] * grad_scale[1]
            if first is None:
                first = {k: g.clone() for k, g in grads.items()}
            opt.step(grads)
            losses.append({"loss": loss.item(),
                           **{k: v.item() for k, v in terms.items()}})
    return losses, first, {k: v.detach().clone() for k, v in leaves.items()}


# ---------------------------------------------------------------------------
# the test-time pose step
# ---------------------------------------------------------------------------


def pose_steps(nerf, pose, init_c2w, eval_imgs, K, steps, cfg, n_points,
               noise_gen, mm, keep_rays=None, grad_scale=None):
    """Run the pose-optimisation steps ``steps`` [(frame, lr)] from the
    pose table ``pose`` {'r', 't'} (copied) on the frozen field. Returns
    (losses, each view's gradient at its first step as a table like
    ``pose``, the table after the last step). ``grad_scale``, a planted
    fault for setting limits, scales the pose gradient."""
    rcfg, mcfg = cfg["rendering"], cfg["model"]
    H, W = eval_imgs.shape[1:3]
    dev = eval_imgs.device
    nerf = {k: {kk: t.detach() for kk, t in v.items()} for k, v in
            nerf.items()}
    pose = {k: v.detach().clone().requires_grad_(True)
            for k, v in pose.items()}
    opt = Adam(pose, {"r": 0.0, "t": 0.0})
    eye = torch.eye(4, device=dev)
    losses = []
    first = {k: torch.zeros_like(v) for k, v in pose.items()}
    seen = set()
    with full_f32():
        for f, lr in steps:
            idx = torch.randint(0, H * W, (n_points,), generator=noise_gen,
                                device=dev)
            c2w = c2w_of(pose["r"][f], pose["t"][f]) @ init_c2w[f]
            ray = rays(pixel_coords(idx, H, W),
                       torch.ones(n_points, device=dev), K,
                       rigid_inverse(c2w), eye, rcfg)
            rgb, _ = render(nerf, ray, mcfg, rcfg, mm)
            gt = eval_imgs[f].reshape(-1, 3)[idx]
            if keep_rays is not None:
                rgb, gt = rgb[:keep_rays], gt[:keep_rays]
            loss = torch.mean((rgb - gt) ** 2)
            grads = dict(zip(pose, torch.autograd.grad(loss,
                                                       list(pose.values()))))
            if grad_scale is not None:
                grads = {k: g * grad_scale for k, g in grads.items()}
            if f not in seen:
                seen.add(f)
                for k, g in grads.items():
                    first[k][f] = g[f]
            opt.lrs = {"r": lr, "t": lr}
            opt.step(grads)
            losses.append(loss.item())
    return losses, first, {k: v.detach().clone() for k, v in pose.items()}
