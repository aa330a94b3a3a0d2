#!/usr/bin/env python
"""Write the JAX package's synthetic teacher fields as npz fixtures for the
PyTorch port.

The JAX teacher of ``nope_nerf_tpu/utils/synthetic.py::SyntheticScene`` is
``init_nerf_params(PRNGKey(seed + 100))`` at width 64 with ``trunk0_0.w``
times 4; the port draws its own from a ``torch.Generator``, so the same
``--seed`` gives the two packages different scenes. With one of these files
``python -m nope_nerf_tpu_torch.make_synthetic_dataset --teacher`` renders
the scene that ``tools/make_synthetic_dataset.py`` renders at that seed
(the scene of the JAX end-to-end scripts' rows).

Runs on the CPU with JAX:
    JAX_PLATFORMS=cpu python tools/torch_teacher_fixture.py [--seeds 3 4]
        [--out-dir tests/fixtures]
writes ``<out-dir>/teacher_seed<seed>.npz`` in the checkpoint format of
both packages (``training/checkpoints.py``: '/'-joined leaf paths of the
nerf group, scalars {"seed": seed}).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[3, 4])
    ap.add_argument("--out-dir", default=os.path.normpath(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "tests",
        "fixtures")))
    args = ap.parse_args(argv)

    import jax

    from nope_nerf_tpu.training.checkpoints import save_pytree
    from nope_nerf_tpu.utils.synthetic import SyntheticScene

    os.makedirs(args.out_dir, exist_ok=True)
    for seed in args.seeds:
        # a one-pixel scene: only its teacher field is kept
        teacher = jax.device_get(
            SyntheticScene(n_frames=1, hw=(1, 1), seed=seed,
                           num_points=2).teacher)
        path = os.path.join(args.out_dir, f"teacher_seed{seed}.npz")
        save_pytree(path, teacher, seed=seed)
        print(f"wrote {path}")


if __name__ == "__main__":
    main()
