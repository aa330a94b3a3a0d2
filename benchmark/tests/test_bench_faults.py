"""Whole runs of tiny cells on the CPU with the timed path broken
underneath: ``correct`` has to come out false for each fault the cell can
have (a step that leaves its state unchanged, half the batch left out with
the mean over the rest, a gradient doubled or negated where the backward
produces it, an answer altered where it is produced). One card only, so
no exchange between cards can be left out."""
import pytest
import torch


def no_step(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)


def half_rgb_batch(monkeypatch):
    import nope_nerf_tpu_torch.losses.losses as losses

    real_rgb, real_depth = losses.rgb_full_loss, losses.depth_loss_l1

    def rgb(pred, gt, w_l1, w_l2, mesh=None, n=None):
        h = pred.shape[0] // 2
        return real_rgb(pred[:h], gt[:h], w_l1, w_l2, mesh)

    def depth(pred, gt, valid, mesh=None):
        h = pred.shape[0] // 2
        return real_depth(pred[:h], gt[:h], valid[:h], mesh)

    monkeypatch.setattr(losses, "rgb_full_loss", rgb)
    monkeypatch.setattr(losses, "depth_loss_l1", depth)


def half_pose_batch(monkeypatch):
    import nope_nerf_tpu_torch.evaluation.pose_opt as pose_opt

    real = pose_opt.pose_opt_loss

    def loss(pose_params, nerf_params, eval_imgs, camera_mat, scale_mat, i,
             ray_idx, init_c2w, render_cfg):
        return real(pose_params, nerf_params, eval_imgs, camera_mat,
                    scale_mat, i, ray_idx[:ray_idx.shape[0] // 2], init_c2w,
                    render_cfg)

    monkeypatch.setattr(pose_opt, "pose_opt_loss", loss)


def scaled_grad(t, factor):
    """``t`` in the forward, ``factor`` times its gradient in the backward
    (2t - t and -t + 2t are t exactly in floating point)."""
    return factor * t + (1.0 - factor) * t.detach()


def trunk_grad(factor):
    """One trunk layer's weight gradient scaled where the field's backward
    produces it."""
    def plant(monkeypatch):
        import nope_nerf_tpu_torch.training.trainer as trainer

        real = trainer.render_ray_batch

        def render(nerf_params, *args, **kw):
            layer = dict(nerf_params["trunk1_1"])
            layer["w"] = scaled_grad(layer["w"], factor)
            return real(dict(nerf_params, trunk1_1=layer), *args, **kw)

        monkeypatch.setattr(trainer, "render_ray_batch", render)
    plant.__name__ = f"trunk_grad_x{factor:g}"
    return plant


def pose_grad(factor):
    """The pose gradient scaled where the input-only backward produces it."""
    def plant(monkeypatch):
        import nope_nerf_tpu_torch.evaluation.pose_opt as pose_opt

        real = pose_opt.pose_opt_loss

        def loss(pose_params, *args):
            return real({k: scaled_grad(v, factor)
                         for k, v in pose_params.items()}, *args)

        monkeypatch.setattr(pose_opt, "pose_opt_loss", loss)
    plant.__name__ = f"pose_grad_x{factor:g}"
    return plant


def altered_render(monkeypatch):
    import nope_nerf_tpu_torch.ops.rendering as rendering

    real = rendering.render_image

    def render(*args, **kw):
        rgb, depth = real(*args, **kw)
        return rgb.flip(0), depth

    monkeypatch.setattr(rendering, "render_image", render)


FAULTS = [
    ("tanks_ballroom.train", no_step),
    ("tanks_ballroom.train", half_rgb_batch),
    ("tanks_ballroom.train", trunk_grad(2.0)),
    ("tanks_ballroom.train", trunk_grad(-1.0)),
    ("llff_fern.train", no_step),
    ("llff_fern.train", half_rgb_batch),
    ("llff_fern.train", trunk_grad(2.0)),
    ("tanks_ballroom.pose_opt", no_step),
    ("tanks_ballroom.pose_opt", half_pose_batch),
    ("tanks_ballroom.pose_opt", pose_grad(2.0)),
    ("tanks_ballroom.pose_opt", pose_grad(-1.0)),
    ("tanks_ballroom.render", altered_render),
]


@pytest.mark.parametrize("workload,fault", FAULTS,
                         ids=[f"{w}-{f.__name__}" for w, f in FAULTS])
def test_a_broken_path_is_not_correct(tiny, monkeypatch, workload, fault):
    assert tiny.run(workload)["correct"], "the sound run must pass first"
    fault(monkeypatch)
    assert not tiny.run(workload)["correct"]
