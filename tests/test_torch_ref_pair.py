"""The reference pair (``nope_nerf_tpu_torch/ops/kernels/ref_pair.py``) on
the CPU: its plain version against the training step's tensor code it was
moved from, bit for bit; the wrapper's devices; and the backward's algebra
of ``csrc/ref_pair.cu`` (each point's share of its 41 sums, then the 4x4
chain back to the inputs) replayed in float64 against autograd of the plain
version. The kernel itself runs only on the card
(``tests/test_torch_cuda.py::test_ref_pair_matches_plain``).
"""
import numpy as np
import pytest
import torch

from nope_nerf_tpu_torch.geometry.rays import (arange_pixels, project_to_cam,
                                               rigid_inv, transform_to_world)
from nope_nerf_tpu_torch.geometry.so3 import make_c2w
from nope_nerf_tpu_torch.models.pose import take_rows
from nope_nerf_tpu_torch.ops.interp import grid_sample
from nope_nerf_tpu_torch.ops.kernels import ref_pair as rp
from nope_nerf_tpu_torch.ops.kernels.chamfer_band import (TILE,
                                                          rows_to_start_tiles)

# (swap, device index, learn_dist, shift_first, scale_pcs, rgb_s,
#  detach_rgbs_scale, auto_mask, chamfer_mode)
CASES = [
    (False, True, True, False, True, True, False, False, "band"),
    (True, True, True, True, False, True, True, True, "auto"),
    (True, False, False, False, True, False, False, False, "band"),
    (False, False, True, False, True, True, True, False, "exact"),
]


def _cfg(case):
    swap, dev_idx, learn_dist, shift_first, scale_pcs, rgb, detach, auto, \
        mode = case
    return {"_num_cams": 4,
            "training": {"nearest_limit": 0.01, "shift_first": shift_first,
                         "scale_pcs": scale_pcs, "detach_rgbs_scale": detach,
                         "with_auto_mask": auto, "pc_ratio": 4},
            "distortion": {"learn_distortion": learn_dist},
            "tpu": {"chamfer_mode": mode, "chamfer_band_rows": 32}}


def _inputs(case, hs=23, ws=40, dtype=torch.float32, seed=0):
    """A seeded pair: 4-frame tables of depth maps (a corner patch below the
    near limit) and images, poses, distortion scalars, the stock camera's
    form; leaves require gradients."""
    swap, dev_idx = case[:2]
    rng = np.random.default_rng(seed)
    dtab = 1.5 + rng.uniform(0, 1, (4, hs, ws))
    dtab[:, :3, :4] = rng.uniform(-0.02, 0.05, (4, 3, 4))
    itab = rng.uniform(0, 1, (4, hs, ws, 3))

    def t(a, grad=False):
        return torch.tensor(np.asarray(a), dtype=dtype).requires_grad_(grad)

    idx, ref = (3, 1) if swap else (1, 2)
    poses = [make_c2w(torch.tensor(rng.normal(0, 0.1, 3), dtype=dtype),
                      torch.tensor(rng.normal(0, 0.2, 3), dtype=dtype))
             for _ in range(2)]
    c2w = poses[0].detach().requires_grad_()
    world = rigid_inv(poses[0].detach()).requires_grad_()
    c2w_ref = poses[1].detach().requires_grad_()
    scalars = [t([v], True) for v in (1.05, 0.03, 0.93, -0.02)]
    cam = t([[1.6, 0, 0, 0], [0, -2.8, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1]],
            True)
    rows = [torch.tensor(v) if dev_idx else v for v in (idx, ref)]
    return (t(dtab), t(itab), rows, c2w, world, c2w_ref, scalars, cam)


def _inline(dpts_small, imgs_small, idx, ref_idx, c2w, world_mat, c2w_ref,
            scale_input, shift_input, scale_ref, shift_ref, camera_mat, cfg,
            use_rgb_s):
    """The reference-image branch as ``training/trainer.py::compute_loss``
    ran it inline before it moved into ``ops/kernels/ref_pair.py``."""
    tcfg, tpu = cfg["training"], cfg["tpu"]
    nl, num_cams = tcfg["nearest_limit"], cfg["_num_cams"]
    learn_dist = cfg["distortion"]["learn_distortion"]
    dev = dpts_small.device
    hd, wd = 4 * dpts_small.shape[1], 4 * dpts_small.shape[2]

    def _apply_distortion(depth, scale, shift, shift_first):
        if shift_first:
            return (depth + shift) * scale
        return depth * scale + shift

    loss_kwargs = {}
    ref_Rt = rigid_inv(c2w_ref)
    swap = idx >= num_cams - 1

    def pick(a, b):
        if torch.is_tensor(swap):
            return torch.where(swap, a, b)
        return a if swap else b

    Rt_rel_12 = pick(world_mat @ c2w_ref, ref_Rt @ c2w)
    R_rel_12 = Rt_rel_12[:3, :3]
    t_rel_12 = Rt_rel_12[:3, 3]
    scale2 = pick(scale_input, scale_ref)

    ratio = tcfg["pc_ratio"]
    sres = (int(hd / ratio), int(wd / ratio))
    _, p_pc = arange_pixels(sres, device=dev)
    dsm_cur = take_rows(dpts_small, idx)
    dsm_ref = take_rows(dpts_small, ref_idx)
    d1s, d2s = pick(dsm_ref, dsm_cur), pick(dsm_cur, dsm_ref)
    if learn_dist:
        scale1 = pick(scale_ref, scale_input)
        shift1 = pick(shift_ref, shift_input)
        shift2 = pick(shift_input, shift_ref)
        d1s = _apply_distortion(d1s, scale1, shift1, tcfg["shift_first"])
        d2s = _apply_distortion(d2s, scale2, shift2, tcfg["shift_first"])
    d1s = torch.clamp_min(d1s, nl)
    d2s = torch.clamp_min(d2s, nl)
    pc1 = transform_to_world(p_pc, d1s.reshape(-1), camera_mat)
    pc2 = transform_to_world(p_pc, d2s.reshape(-1), camera_mat)

    if use_rgb_s:
        ism_cur = take_rows(imgs_small, idx)
        ism_ref = take_rows(imgs_small, ref_idx)
        img1s, img2s = pick(ism_ref, ism_cur), pick(ism_cur, ism_ref)
        pc1_for_rgb = pc1.detach() if tcfg["detach_rgbs_scale"] else pc1
        pc1_rot = pc1_for_rgb @ R_rel_12.t() + t_rel_12
        invalid = -pc1_rot[:, 2:] < nl
        pc1_rot = torch.where(invalid, torch.full_like(pc1_rot, nl),
                              pc1_rot)
        p_reproj, valid = project_to_cam(pc1_rot, camera_mat)
        rgb_pc1_proj = grid_sample(img2s, p_reproj, mode="bilinear",
                                   align_corners=True)
        loss_kwargs["rgb_pc1"] = img1s
        loss_kwargs["rgb_pc1_proj"] = rgb_pc1_proj.reshape(sres[0],
                                                           sres[1], 3)
        loss_kwargs["valid_points"] = valid.to(torch.float32).reshape(
            sres[0], sres[1], 1)
        if tcfg.get("with_auto_mask", False):
            loss_kwargs["rgb_pc1_ori"] = img2s

    pc1 = pc1 @ R_rel_12.t() + t_rel_12
    if tpu.get("chamfer_mode", "exact") in ("band", "auto"):
        band_rows = tpu.get("chamfer_band_rows", 32)
        k_band = tpu.get("chamfer_band_tiles") or max(
            2, round(band_rows * sres[1] / TILE))
        n_pc = sres[0] * sres[1]
        q21 = (pc2 - t_rel_12) @ R_rel_12
        loss_kwargs["chamfer_starts"] = (
            rows_to_start_tiles(pc1, n_pc, sres, camera_mat,
                                project_to_cam, k_band),
            rows_to_start_tiles(q21, n_pc, sres, camera_mat,
                                project_to_cam, k_band),
        )
        loss_kwargs["chamfer_band_tiles"] = k_band
    if tcfg["scale_pcs"]:
        pc1 = pc1 / scale2
        pc2 = pc2 / scale2
    loss_kwargs["X"] = pc1
    loss_kwargs["Y"] = pc2
    return loss_kwargs


def _grads(out, leaves, seed=1):
    """Gradients of a seeded projection of the differentiable outputs."""
    g = torch.Generator().manual_seed(seed)
    loss = sum((out[k] * torch.randn(out[k].shape, generator=g,
                                     dtype=out[k].dtype)).sum()
               for k in ("X", "Y", "rgb_pc1_proj") if k in out)
    return torch.autograd.grad(loss, leaves, allow_unused=True)


@pytest.mark.parametrize("case", CASES)
def test_plain_version_equals_the_inline_code(case):
    """``ref_pair`` on CPU tensors (its plain version) against the step's
    inline code it replaced, on a seeded pair: every output and every
    gradient bit for bit."""
    results = []
    for fn in ("inline", "module"):
        dtab, itab, (idx, ref), c2w, world, c2w_ref, sc, cam = _inputs(case)
        cfg, rgb = _cfg(case), case[5]
        leaves = [c2w, world, c2w_ref, *sc, cam]
        if fn == "inline":
            out = _inline(dtab, itab, idx, ref, c2w, world, c2w_ref, *sc,
                          cam, cfg, rgb)
        else:
            spec = rp.pair_spec(cfg, rgb, tuple(dtab.shape[1:]))
            out = rp.ref_pair((dtab, idx, ref), (itab, idx, ref) if rgb
                              else None, idx, c2w, world, c2w_ref, *sc, cam,
                              spec)
        results.append((out, _grads(out, leaves)))
    (oi, gi), (om, gm) = results
    assert sorted(oi) == sorted(om)
    for k in oi:
        a, b = oi[k], om[k]
        if isinstance(a, tuple):
            assert all(torch.equal(x, y) for x, y in zip(a, b))
        elif torch.is_tensor(a):
            assert torch.equal(a, b), k
        else:
            assert a == b
    for a, b in zip(gi, gm):
        assert (a is None and b is None) or torch.equal(a, b)


def test_pair_spec_reads_the_band_tiles():
    """The band's tiles as the step computed them: ``chamfer_band_rows``
    rows of the grid, at least 2, or ``chamfer_band_tiles``; none without
    band starts."""
    cfg = _cfg(CASES[0])
    assert rp.pair_spec(cfg, True, (135, 240)).band_tiles == 8
    assert rp.pair_spec(cfg, True, (189, 252)).band_tiles == 8
    assert rp.pair_spec(cfg, True, (10, 20)).band_tiles == 2
    cfg["tpu"]["chamfer_band_tiles"] = 5
    assert rp.pair_spec(cfg, True, (135, 240)).band_tiles == 5
    cfg["tpu"]["chamfer_mode"] = "exact"
    assert rp.pair_spec(cfg, True, (135, 240)).band_tiles is None


def test_wrapper_refuses_other_devices():
    """Neither CPU nor CUDA: the wrapper raises, with no plain fallback."""
    dtab, itab, (idx, ref), c2w, world, c2w_ref, sc, cam = _inputs(CASES[2])
    spec = rp.pair_spec(_cfg(CASES[2]), False, tuple(dtab.shape[1:]))
    meta = [t.detach().to("meta") for t in (dtab, c2w, world, c2w_ref, *sc,
                                            cam)]
    with pytest.raises(ValueError, match="unsupported device meta"):
        rp.ref_pair((meta[0], idx, ref), None, idx, *meta[1:], spec)


def _replayed_backward(dtab, itab, idx, ref, c2w, world, c2w_ref, sc, cam,
                       spec, cots):
    """csrc/ref_pair.cu's backward in float64: each point's share of the
    sums (ref_pair_bwd_kernel's point_bwd, vectorised), then
    ref_pair_bwd_final_kernel's algebra."""
    c2w, world, c2w_ref, cam = (m.detach() for m in (c2w, world, c2w_ref,
                                                     cam))
    sc = [s.detach()[0] for s in sc]
    swap = idx >= spec.num_cams - 1
    rt = world @ c2w_ref if swap else rigid_inv(c2w_ref) @ c2w
    R, t = rt[:3, :3], rt[:3, 3]
    T, K = torch.linalg.inv(cam), cam
    sc1, sh1, sc2, sh2 = ((sc[2], sc[3], sc[0], sc[1]) if swap
                          else (sc[0], sc[1], sc[2], sc[3]))
    hs, ws = dtab.shape[1:]
    d1 = dtab[ref if swap else idx].reshape(-1)
    d2 = dtab[idx if swap else ref].reshape(-1)
    n = hs * ws
    r, c = torch.arange(n) // ws, torch.arange(n) % ws
    px, py = 2.0 * c / (ws - 1) - 1, 2.0 * r / (hs - 1) - 1
    nl = spec.nearest_limit

    def distort(raw, s, h):
        if not spec.learn_dist:
            return raw
        return (raw + h) * s if spec.shift_first else raw * s + h

    pre = [distort(d1, sc1, sh1), distort(d2, sc2, sh2)]
    hom = []
    for p in pre:
        d = torch.clamp_min(p, nl)
        hom.append(torch.stack([px * d, py * d, d, torch.ones_like(d)], 1))
    pc1, pc2 = hom[0] @ T[:3].T, hom[1] @ T[:3].T
    xu = pc1 @ R.T + t
    gX, gY, gO = cots
    if spec.scale_pcs:
        gxu, gp2 = gX / sc2, gY / sc2
        gs2 = -(gX * (xu / sc2 / sc2) + gY * (pc2 / sc2 / sc2)).sum()
    else:
        gxu, gp2, gs2 = gX, gY, 0.0
    dR, dt, gp1 = gxu.T @ pc1, gxu.sum(0), gxu @ R
    dK = torch.zeros(3, 4, dtype=dtab.dtype)
    if spec.use_rgb_s:
        img2 = itab[idx if swap else ref]
        invalid = -xu[:, 2] < nl
        q = torch.where(invalid[:, None], torch.full_like(xu, nl), xu)
        qh = torch.cat([q, torch.ones(n, 1, dtype=q.dtype)], 1)
        xh = qh @ K[:3].T
        x, y = xh[:, 0] / xh[:, 2], xh[:, 1] / xh[:, 2]
        fx, fy = (x + 1) / 2 * (ws - 1), (y + 1) / 2 * (hs - 1)
        x0, y0 = torch.floor(fx), torch.floor(fy)
        wx, wy = (1 - (fx - x0), fx - x0), (1 - (fy - y0), fy - y0)
        gwx, gwy = [0, 0], [0, 0]
        for a in range(2):
            for b in range(2):
                xi, yi = x0 + a, y0 + b
                inb = ((xi >= 0) & (xi < ws) & (yi >= 0)
                       & (yi < hs)).to(q.dtype)
                v = img2[yi.clamp(0, hs - 1).long(),
                         xi.clamp(0, ws - 1).long()]
                gw = (gO.reshape(-1, 3) * v).sum(1) * inb
                gwx[a] = gwx[a] + gw * wy[b]
                gwy[b] = gwy[b] + gw * wx[a]
        gx = (gwx[1] - gwx[0]) * (ws - 1) * 0.5
        gy = (gwy[1] - gwy[0]) * (hs - 1) * 0.5
        gxh = torch.stack([gx / xh[:, 2], gy / xh[:, 2],
                           -(gx * x + gy * y) / xh[:, 2]], 1)
        dK = gxh.T @ qh
        gq = torch.where(invalid[:, None], 0.0, gxh @ K[:3, :3])
        dR, dt = dR + gq.T @ pc1, dt + gq.sum(0)
        if not spec.detach_rgbs_scale:
            gp1 = gp1 + gq @ R
    dT = gp1.T @ hom[0] + gp2.T @ hom[1]
    gs = []
    for gp, p, raw, s, h in ((gp1, pre[0], d1, sc1, sh1),
                             (gp2, pre[1], d2, sc2, sh2)):
        gh = gp @ T[:3, :3]
        gd = torch.where(p >= nl, gh[:, 0] * px + gh[:, 1] * py + gh[:, 2],
                         0.0)
        if spec.learn_dist:
            gs += [(gd * ((raw + h) if spec.shift_first else raw)).sum(),
                   (gd * (s if spec.shift_first else 1.0)).sum()]
        else:
            gs += [0.0, 0.0]
    # ref_pair_bwd_final_kernel
    G = torch.zeros(4, 4, dtype=dtab.dtype)
    G[:3, :3], G[:3, 3] = dR, dt
    zero = torch.zeros(4, 4, dtype=dtab.dtype)
    if swap:
        g_c2w, g_world, g_ref = zero, G @ c2w_ref.T, world.T @ G
    else:
        g_rt = G @ c2w.T
        g_c2w, g_world = rigid_inv(c2w_ref).T @ G, zero
        g_ref = torch.zeros(4, 4, dtype=dtab.dtype)
        g_ref[:3, :3] = g_rt[:3, :3].T
        gb = -g_rt[:3, 3]
        g_ref[:3, :3] += c2w_ref[:3, 3:4] * gb[None, :]
        g_ref[:3, 3] = c2w_ref[:3, :3] @ gb
    g1, g2 = gs[:2], [gs[2] + gs2, gs[3]]
    gcur, gref = (g2, g1) if swap else (g1, g2)
    dT4 = torch.zeros(4, 4, dtype=dtab.dtype)
    dT4[:3] = dT
    g_cam = -(T.T @ dT4 @ T.T)
    g_cam[:3] += dK
    return [g_c2w, g_world, g_ref, *gcur, *gref, g_cam]


@pytest.mark.parametrize("case", CASES)
def test_kernel_backward_algebra_replayed(case, monkeypatch):
    """The backward's formulas of csrc/ref_pair.cu, replayed in float64 on
    the CPU, against autograd of the plain version in float64: every
    gradient within 1e-9 of its largest entry (float64 rounding only)."""
    def pixels64(sres, device=None):
        loc, scaled = arange_pixels(sres, device=device)
        return loc, scaled.double()

    monkeypatch.setattr(rp, "arange_pixels", pixels64)
    dtab, itab, (idx, ref), c2w, world, c2w_ref, sc, cam = _inputs(
        case, dtype=torch.float64)
    idx, ref = int(idx), int(ref)
    rgb = case[5]
    spec = rp.pair_spec(_cfg(case), rgb, tuple(dtab.shape[1:]))
    out = rp.ref_pair_reference((dtab, idx, ref), (itab, idx, ref), idx,
                                c2w, world, c2w_ref, *sc, cam, spec)
    g = torch.Generator().manual_seed(3)
    cots = [torch.randn(s, generator=g, dtype=torch.float64)
            for s in (out["X"].shape, out["Y"].shape,
                      (dtab.shape[1] * dtab.shape[2], 3))]
    outs = [out["X"], out["Y"]] + ([out["rgb_pc1_proj"]] if rgb else [])
    leaves = [c2w, world, c2w_ref, *sc, cam]
    want = torch.autograd.grad(outs, leaves, [c.reshape(o.shape) for c, o in
                                              zip(cots, outs)],
                               allow_unused=True, materialize_grads=True)
    got = _replayed_backward(dtab, itab, idx, ref, c2w, world, c2w_ref, sc,
                             cam, spec, cots)
    assert (~(dtab[:, :3, :4] >= 0.01)).any()  # some depths clamp
    for w, k in zip(want, got):
        k = torch.as_tensor(k, dtype=torch.float64).reshape(w.shape)
        scale = max(float(w.abs().max()), 1e-12)
        assert float((w - k).abs().max()) <= 1e-9 * scale
