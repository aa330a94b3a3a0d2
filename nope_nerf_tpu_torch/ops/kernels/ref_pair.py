"""The reference pair of the training step in one kernel each way.

The reference-image branch of ``training/trainer.py::compute_loss``: the two
backprojected small depth maps (the pc loss's clouds X and Y), the rgb_s
reprojection of the earlier frame into the later one, and Kernel B's band
starts. The JAX package has no kernel here (XLA fused it); on the card the
plain tensor code is some 350 small launches each way.

* :func:`ref_pair` is the public wrapper: CUDA tensors run
  :class:`RefPair` (``csrc/ref_pair.cu``: one forward launch, counted in
  :data:`LAUNCHES`; a backward of two launches, counted once in
  :data:`BWD_LAUNCHES`); CPU tensors run :func:`ref_pair_reference`; any
  other device raises.
* :func:`ref_pair_reference` is the plain version: the branch's tensor code
  as the step ran it, on any device.
* :func:`pair_spec` reads the branch's settings from the config.

Both return the keyword arguments that ``losses.total_loss`` reads: ``X``,
``Y``; with rgb_s ``rgb_pc1``, ``rgb_pc1_proj``, ``valid_points`` and, with
``training.with_auto_mask``, ``rgb_pc1_ori``; with the banded Chamfer modes
``chamfer_starts`` and ``chamfer_band_tiles``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..._build import c_function, check
from ...geometry.rays import (arange_pixels, project_to_cam, rigid_inv,
                              transform_to_world)
from ...models.distortion import apply_distortion
from ...models.pose import take_rows
from ..interp import grid_sample
from . import LaunchCounter
from .chamfer_band import QB, TILE, rows_to_start_tiles

LAUNCHES = LaunchCounter("ref_pair")
BWD_LAUNCHES = LaunchCounter("ref_pair_bwd")

# csrc/ref_pair.cu's flags, and the backward's scratch: one row of _NSUM
# partial sums per block of _BWD_THREADS points
_LEARN_DIST, _SHIFT_FIRST, _RGB, _DETACH_RGBS, _SCALE_PCS = 1, 2, 4, 8, 16
_BWD_THREADS, _NSUM = 256, 41


@dataclass(frozen=True)
class PairSpec:
    """The settings of the branch: ``num_cams`` (the frame order's swap is
    ``idx >= num_cams - 1``), ``nearest_limit``, ``shift_first``,
    ``learn_dist``, ``scale_pcs``, ``use_rgb_s``, ``detach_rgbs_scale``,
    ``auto_mask`` and ``band_tiles`` (None: no band starts)."""

    num_cams: int
    nearest_limit: float
    shift_first: bool
    learn_dist: bool
    scale_pcs: bool
    use_rgb_s: bool
    detach_rgbs_scale: bool
    auto_mask: bool
    band_tiles: int | None


def pair_spec(cfg, use_rgb_s, sres):
    """The :class:`PairSpec` of ``cfg`` for clouds on the (hs, ws) grid
    ``sres``: band starts under ``tpu.chamfer_mode`` band or auto, over
    ``tpu.chamfer_band_tiles`` tiles or as many as ``chamfer_band_rows``
    rows of the grid take (at least 2)."""
    tcfg = cfg["training"]
    tpu = cfg.get("tpu", {}) or {}
    band = None
    if tpu.get("chamfer_mode", "exact") in ("band", "auto"):
        band_rows = tpu.get("chamfer_band_rows", 32)
        band = tpu.get("chamfer_band_tiles") or max(
            2, round(band_rows * sres[1] / TILE))
    return PairSpec(
        num_cams=cfg["_num_cams"], nearest_limit=tcfg["nearest_limit"],
        shift_first=tcfg["shift_first"],
        learn_dist=cfg["distortion"]["learn_distortion"],
        scale_pcs=tcfg["scale_pcs"], use_rgb_s=bool(use_rgb_s),
        detach_rgbs_scale=tcfg["detach_rgbs_scale"],
        auto_mask=tcfg.get("with_auto_mask", False), band_tiles=band)


def ref_pair_reference(depths, images, idx, c2w, world_mat, c2w_ref,
                       scale_input, shift_input, scale_ref, shift_ref,
                       camera_mat, spec):
    """Plain PyTorch version of :func:`ref_pair` (the step's tensor code)."""
    dtab, dcur, dref = depths
    dev = dtab.device
    nl = spec.nearest_limit
    out = {}
    ref_Rt = rigid_inv(c2w_ref)
    # frame ordering: the pair is (earlier=1, later=2)
    swap = idx >= spec.num_cams - 1

    def pick(a, b):
        """``a`` where the pair swaps, else ``b``."""
        if torch.is_tensor(swap):
            return torch.where(swap, a, b)
        return a if swap else b

    Rt_rel_12 = pick(world_mat @ c2w_ref, ref_Rt @ c2w)
    R_rel_12 = Rt_rel_12[:3, :3]
    t_rel_12 = Rt_rel_12[:3, 3]
    scale2 = pick(scale_input, scale_ref)

    sres = tuple(dtab.shape[1:3])
    _, p_pc = arange_pixels(sres, device=dev)
    dsm_cur = take_rows(dtab, dcur)
    dsm_ref = take_rows(dtab, dref)
    d1s, d2s = pick(dsm_ref, dsm_cur), pick(dsm_cur, dsm_ref)
    if spec.learn_dist:
        scale1 = pick(scale_ref, scale_input)
        shift1 = pick(shift_ref, shift_input)
        shift2 = pick(shift_input, shift_ref)
        d1s = apply_distortion(d1s, scale1, shift1, spec.shift_first)
        d2s = apply_distortion(d2s, scale2, shift2, spec.shift_first)
    d1s = torch.clamp_min(d1s, nl)
    d2s = torch.clamp_min(d2s, nl)
    pc1 = transform_to_world(p_pc, d1s.reshape(-1), camera_mat)
    pc2 = transform_to_world(p_pc, d2s.reshape(-1), camera_mat)

    if spec.use_rgb_s:
        itab, icur, iref = images
        ism_cur = take_rows(itab, icur)
        ism_ref = take_rows(itab, iref)
        img1s, img2s = pick(ism_ref, ism_cur), pick(ism_cur, ism_ref)
        pc1_for_rgb = pc1.detach() if spec.detach_rgbs_scale else pc1
        pc1_rot = pc1_for_rgb @ R_rel_12.t() + t_rel_12
        # clamp points behind the near limit (all 3 coordinates)
        invalid = -pc1_rot[:, 2:] < nl
        pc1_rot = torch.where(invalid, torch.full_like(pc1_rot, nl),
                              pc1_rot)
        p_reproj, valid = project_to_cam(pc1_rot, camera_mat)
        rgb_pc1_proj = grid_sample(img2s, p_reproj, mode="bilinear",
                                   align_corners=True)
        # img1s sampled at its own pixel grid is the identity
        out["rgb_pc1"] = img1s
        out["rgb_pc1_proj"] = rgb_pc1_proj.reshape(sres[0], sres[1], 3)
        out["valid_points"] = valid.to(torch.float32).reshape(
            sres[0], sres[1], 1)
        if spec.auto_mask:
            out["rgb_pc1_ori"] = img2s

    pc1 = pc1 @ R_rel_12.t() + t_rel_12
    if spec.band_tiles is not None:
        k_band = spec.band_tiles
        n_pc = sres[0] * sres[1]
        q21 = (pc2 - t_rel_12) @ R_rel_12
        out["chamfer_starts"] = (
            rows_to_start_tiles(pc1, n_pc, sres, camera_mat,
                                project_to_cam, k_band),
            rows_to_start_tiles(q21, n_pc, sres, camera_mat,
                                project_to_cam, k_band),
        )
        out["chamfer_band_tiles"] = k_band
    if spec.scale_pcs:
        pc1 = pc1 / scale2
        pc2 = pc2 / scale2
    out["X"] = pc1
    out["Y"] = pc2
    return out


def _index(v, dev, what):
    """(device pointer or 0, host value) of a frame or row index: a host
    int, or a 0-d int64 tensor on ``dev``."""
    if torch.is_tensor(v):
        if v.device != dev or v.dtype != torch.int64 or v.numel() != 1:
            raise ValueError(f"ref_pair: {what} must be a host int or one "
                             f"int64 on {dev}, got {v.dtype} {tuple(v.shape)}"
                             f" on {v.device}")
        return v.data_ptr(), 0
    return 0, int(v)


def _flags(spec):
    return ((_LEARN_DIST if spec.learn_dist else 0)
            | (_SHIFT_FIRST if spec.shift_first else 0)
            | (_RGB if spec.use_rgb_s else 0)
            | (_DETACH_RGBS if spec.detach_rgbs_scale else 0)
            | (_SCALE_PCS if spec.scale_pcs else 0))


_PAIR_SIG = "pp" + "pi" * 5 + "pppp" + "pppp" + "iiiii" + "f"


def _scratch_floats(n):
    return -(-n // _BWD_THREADS) * _NSUM


class RefPair(torch.autograd.Function):
    """The pair on ``csrc/ref_pair.cu``. forward(spec, dtab, itab, rows,
    c2w, world_mat, c2w_ref, scale_cur, shift_cur, scale_ref, shift_ref,
    camera_mat, *index_tensors) -> (X, Y, rgb_pc1_proj, valid_points,
    rgb_pc1, rgb_pc1_ori, starts); ``rows`` holds the five indices (the
    frame, its depth row, the reference's, their image rows), each a host
    int or one of ``index_tensors``. The outputs that the spec does not ask
    for are empty. Gradients reach the matrices and the four scalars."""

    @staticmethod
    def _common(spec, dtab, itab, rows, mats):
        dev = dtab.device
        hs, ws = dtab.shape[1:3]
        args = [dtab.data_ptr(), itab.data_ptr() if itab is not None else 0]
        for v, what in zip(rows, ("idx", "the depth row", "the reference's "
                                  "depth row", "the image row",
                                  "the reference's image row")):
            args += _index(v, dev, what)
        # csrc/ref_pair.cu takes camera_mat before the four scalars
        args += [m.data_ptr() for m in (*mats[:3], mats[7], *mats[3:7])]
        args += [hs, ws, spec.num_cams, _flags(spec), spec.band_tiles or 0,
                 float(spec.nearest_limit)]
        return args

    @staticmethod
    def forward(ctx, spec, dtab, itab, rows, *tensors):
        mats = tensors[:8]
        dev = dtab.device
        hs, ws = dtab.shape[1:3]
        n = hs * ws
        common = RefPair._common(spec, dtab, itab, rows, mats)
        X = torch.empty((n, 3), dtype=torch.float32, device=dev)
        Y = torch.empty_like(X)
        if spec.use_rgb_s:
            rgb = torch.empty((hs, ws, 3), dtype=torch.float32, device=dev)
            valid = torch.empty((hs, ws, 1), dtype=torch.float32, device=dev)
            img1 = torch.empty_like(rgb)
            img2 = torch.empty_like(rgb) if spec.auto_mask else None
        else:
            rgb = valid = img1 = img2 = None
        groups = -(-n // QB)
        starts = (torch.empty((2, groups), dtype=torch.int32, device=dev)
                  if spec.band_tiles is not None else None)

        def ptr(t):
            return t.data_ptr() if t is not None else 0

        err = c_function("nnt_ref_pair_fwd", _PAIR_SIG + "ppppppp" + "p")(
            *common, X.data_ptr(), Y.data_ptr(), ptr(rgb), ptr(valid),
            ptr(img1), ptr(img2), ptr(starts),
            torch.cuda.current_stream(dev).cuda_stream)
        check(err, "ref_pair_fwd")
        LAUNCHES.add()
        # the index tensors are saved among ``tensors``; rows keeps their
        # places
        ctx.spec = spec
        ctx.rows = tuple(None if torch.is_tensor(v) else v for v in rows)
        ctx.save_for_backward(dtab, itab, *tensors)
        outs = [t if t is not None else torch.empty(0, device=dev)
                for t in (rgb, valid, img1, img2, starts)]
        ctx.mark_non_differentiable(*outs[1:])
        return (X, Y, *outs)

    @staticmethod
    def backward(ctx, gX, gY, gO, *_):
        spec = ctx.spec
        dtab, itab, *tensors = ctx.saved_tensors
        mats, index_tensors = tensors[:8], iter(tensors[8:])
        rows = tuple(next(index_tensors) if v is None else v
                     for v in ctx.rows)
        dev = dtab.device
        n = dtab.shape[1] * dtab.shape[2]
        common = RefPair._common(spec, dtab, itab, rows, mats)
        gX, gY = gX.contiguous(), gY.contiguous()
        gO = gO.contiguous() if spec.use_rgb_s else None
        scratch = torch.empty(_scratch_floats(n), dtype=torch.float32,
                              device=dev)
        out = torch.empty(68, dtype=torch.float32, device=dev)
        err = c_function("nnt_ref_pair_bwd", _PAIR_SIG + "ppppp" + "p")(
            *common, gX.data_ptr(), gY.data_ptr(),
            gO.data_ptr() if gO is not None else 0, scratch.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        check(err, "ref_pair_bwd")
        BWD_LAUNCHES.add()
        need = ctx.needs_input_grad[4:]
        grads = (out[0:16].reshape(4, 4), out[16:32].reshape(4, 4),
                 out[32:48].reshape(4, 4), out[48:49], out[49:50],
                 out[50:51], out[51:52], out[52:68].reshape(4, 4))
        mat_grads = [g if need[i] else None for i, g in enumerate(grads)]
        return (None, None, None, None, *mat_grads,
                *([None] * (len(tensors) - 8)))


def _check_cuda_inputs(depths, images, mats, spec):
    dtab = depths[0]
    dev = dtab.device
    if dtab.dim() != 3 or dtab.dtype != torch.float32:
        raise ValueError("ref_pair: the depth maps must be (T, hs, ws) "
                         "float32")
    shapes = ((4, 4),) * 3 + ((1,),) * 4 + ((4, 4),)
    for m, shape in zip(mats, shapes):
        if (m.device != dev or m.dtype != torch.float32
                or tuple(m.shape) != shape):
            raise ValueError(f"ref_pair: expected float32 {shape} on {dev}, "
                             f"got {m.dtype} {tuple(m.shape)} on {m.device}")
    if spec.use_rgb_s:
        if images is None:
            raise ValueError("ref_pair: rgb_s needs the small images")
        itab = images[0]
        if (itab.device != dev or itab.dtype != torch.float32
                or itab.shape[1:] != (*dtab.shape[1:], 3)):
            raise ValueError("ref_pair: the images must be (T, hs, ws, 3) "
                             "float32 beside the depth maps")
    if dtab.shape[1] * dtab.shape[2] >= 2 ** 30:
        raise ValueError("ref_pair: clouds of 2**30 points or more")


def ref_pair(depths, images, idx, c2w, world_mat, c2w_ref, scale_input,
             shift_input, scale_ref, shift_ref, camera_mat, spec):
    """The reference pair's loss inputs (see the module's docstring).

    depths: (table (T, hs, ws), current frame's row, reference's row);
    images: (table (T, hs, ws, 3), rows) or None without rgb_s; each row,
    and ``idx`` (the current frame, whose order against ``spec.num_cams``
    swaps the pair), a host int or a 0-d int64 tensor on the device.
    c2w, world_mat (its inverse), c2w_ref, camera_mat: (4, 4); the four
    distortion scalars: (1,). ``spec``: :class:`PairSpec`.
    """
    dev = depths[0].device
    if dev.type == "cpu":
        return ref_pair_reference(depths, images, idx, c2w, world_mat,
                                  c2w_ref, scale_input, shift_input,
                                  scale_ref, shift_ref, camera_mat, spec)
    if dev.type != "cuda":
        raise ValueError(f"ref_pair: unsupported device {dev}")
    mats = (c2w, world_mat, c2w_ref, scale_input, shift_input, scale_ref,
            shift_ref, camera_mat)
    _check_cuda_inputs(depths, images, mats, spec)
    dtab = depths[0].contiguous()
    itab = images[0].contiguous() if spec.use_rgb_s else None
    irows = images[1:] if spec.use_rgb_s else (0, 0)
    rows = (idx, *depths[1:], *irows)
    index_tensors = [v for v in rows if torch.is_tensor(v)]
    X, Y, rgb, valid, img1, img2, starts = RefPair.apply(
        spec, dtab, itab, rows, *(m.contiguous() for m in mats),
        *index_tensors)
    out = {"X": X, "Y": Y}
    if spec.use_rgb_s:
        out.update(rgb_pc1=img1, rgb_pc1_proj=rgb, valid_points=valid)
        if spec.auto_mask:
            out["rgb_pc1_ori"] = img2
    if spec.band_tiles is not None:
        out["chamfer_starts"] = (starts[0], starts[1])
        out["chamfer_band_tiles"] = spec.band_tiles
    return out
