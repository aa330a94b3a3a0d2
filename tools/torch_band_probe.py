"""Build variants of Kernel B's split-band kernel (``csrc/chamfer_band.cu``)
and hold each against the per-query kernel it replaced, then time them in
turns, on one GPU.

    python3 tools/torch_band_probe.py base= q8=path/to/copy.cu: ...

Each argument is ``name=[source:]flags``: the kernel source (default the
package's; a variant is an edited copy of it, e.g. with another ``Q``,
``SPLIT`` or ``CHUNK`` constant) compiled with ``-D`` flags (comma
separated, if the copy reads any) into a library of its own under
``build/band_probe/`` with ``-Xptxas -v``, whose registers and spills are
printed. Each variant's ``nnt_band_argmin_split`` must return the per-query
kernel's indices (``nnt_band_argmin`` of the package's build) bit for bit
on the stock pair (chip_smoke's 135x240 depth maps, k_tiles 8) and on
random clouds with ragged tails, every k_tiles, clamped starts, duplicate
rows and NaN and infinite rows. Then, in two rounds (the second in reverse
order), every variant and the per-query kernel (with its two padded
copies, as its wrapper runs it) are timed at the stock pair: device time by
the profiler and CUDA events, in ms per call. Needs a CUDA device.
"""
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SOURCE = os.path.join(ROOT, "nope_nerf_tpu_torch", "csrc", "chamfer_band.cu")
OUT = os.path.join(ROOT, "build", "band_probe")


def build_variants(variants):
    """{name: the variant's nnt_band_argmin_split} for ``name=[source:]flags``
    arguments, compiled in parallel."""
    from nope_nerf_tpu_torch import _build

    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for arg in variants:
        name, spec = arg.split("=", 1)
        src = SOURCE
        if ":" in spec:
            src, spec = spec.split(":", 1)
        flags = [f"-D{f}" for f in spec.split(",") if f]
        lib = os.path.join(OUT, f"{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", *flags,
             "-shared", "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        _, err = proc.communicate()
        notes = [line.strip()[:160] for line in err.splitlines()
                 if "split" in line or "registers" in line or "spill" in line]
        print(f"{name}: nvcc rc {proc.returncode}\n  " + "\n  ".join(notes),
              flush=True)
        if proc.returncode:
            raise RuntimeError(f"{name} did not build:\n{err[-4000:]}")
        fn = ctypes.CDLL(lib).nnt_band_argmin_split
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def variant_call(fn, X, Y, starts, k):
    """Run one variant as ``nearest_idx_banded`` runs the package's."""
    import torch

    from nope_nerf_tpu_torch._build import check
    from nope_nerf_tpu_torch.ops.kernels import chamfer_band as cb

    S, n_tiles, k_tiles, _, _ = cb._check_cuda_inputs(X, Y, starts, k)
    X, Y = X.contiguous(), Y.contiguous()
    out = torch.empty(S, dtype=torch.int32, device=X.device)
    check(fn(X.data_ptr(), Y.data_ptr(), starts.data_ptr(), out.data_ptr(),
             S, Y.shape[0], n_tiles, k_tiles, cb.TILE, cb.QB,
             torch.cuda.current_stream().cuda_stream), "variant")
    return out


def cases(dev):
    """(label, X, Y, starts, k_tiles): random clouds with ragged tails,
    k_tiles from 1 to all of Y's tiles, starts clamped at both ends,
    duplicate rows (ties), NaN and infinite rows."""
    import numpy as np
    import torch

    from nope_nerf_tpu_torch.ops.kernels import chamfer_band as cb

    rng = np.random.default_rng(7)
    out = []
    for S, D in ((100, 900), (1024, 3000), (3000, 5000), (5000, 4100)):
        n_tiles = -(-D // cb.TILE)
        for k in sorted({1, 2, n_tiles, n_tiles + 3}):
            X = rng.normal(size=(S, 3)).astype(np.float32)
            Y = rng.normal(size=(D, 3)).astype(np.float32)
            Y[rng.integers(0, D, D // 4)] = Y[rng.integers(0, D, D // 4)]
            X[: S // 8] = Y[rng.integers(0, D, S // 8)]  # exact hits, ties
            if S >= 1024:
                Y[rng.integers(0, D, 20)] = np.nan
                Y[rng.integers(0, D, 20), rng.integers(0, 3, 20)] = np.inf
                X[rng.integers(0, S, 20)] = np.nan
                X[rng.integers(0, S, 20), 1] = -np.inf
                Y[rng.integers(0, D, 5)] = -1e5  # the sentinel itself
            starts = rng.integers(-2, n_tiles + 2, size=-(-S // cb.QB))
            t = lambda a: torch.tensor(a, device=dev)  # noqa: E731
            out.append((f"S={S} D={D} k={k}", t(X), t(Y),
                        t(starts.astype(np.int32)), k))
    nanq = np.full((1024, 3), np.nan, np.float32)  # every distance NaN
    out.append(("all-NaN queries", torch.tensor(nanq, device=dev),
                out[0][2], torch.zeros(1, dtype=torch.int32, device=dev), 1))
    return out


def main(argv):
    import torch

    import chip_smoke as cs
    from nope_nerf_tpu_torch import _build
    from nope_nerf_tpu_torch.geometry.rays import project_to_cam
    from nope_nerf_tpu_torch.ops.kernels import chamfer_band as cb

    if not torch.cuda.is_available():
        print("torch_band_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    _build.load_library()
    fns = build_variants(argv)
    cfg = cs.stock_cfg()
    ratio = cfg["training"]["pc_ratio"]
    hs, ws = int(cs.H / ratio), int(cs.W / ratio)
    X, Y, cam = cs.depth_pair(dev, hs, ws, cs.SEED + 1)
    k = max(2, round(cfg["tpu"]["chamfer_band_rows"] * ws / cb.TILE))
    starts = cb.rows_to_start_tiles(X, hs * ws, (hs, ws), cam,
                                    project_to_cam, k)
    stock = [("stock pair", X, Y, starts, k), ("stock pair, Y to X", Y, X,
                                                starts, k)]
    inputs = stock + cases(dev)
    for name, fn in fns.items():
        bad = []
        for label, x, y, st, kk in inputs:
            want = cb._nearest_idx_banded_per_query(x, y, st, kk)
            got = variant_call(fn, x, y, st, kk)
            if not torch.equal(got, want):
                bad.append((label, int((got != want).sum())))
        print(f"{name} [{card}]: {len(inputs)} inputs, bitwise the "
              f"per-query kernel's indices except {bad}", flush=True)
    calls = {n: (lambda fn=fn: variant_call(fn, X, Y, starts, k))
             for n, fn in fns.items()}
    calls["pr1"] = lambda: cb._nearest_idx_banded_per_query(X, Y, starts, k)
    times = {n: [] for n in calls}
    for order in (list(calls), list(calls)[::-1]):
        for n in order:
            times[n].append((cs.device_ms(calls[n], iters=50),
                             cs.cuda_ms(calls[n], iters=50)))
    for n, t in times.items():
        print(f"{n} [{card}]: device ms " + " / ".join(
            f"{d:.4f}" for d, _ in t) + "; events ms " + " / ".join(
            f"{e:.4f}" for _, e in t), flush=True)
    print(f"pr1 by kernel [{card}], device ms: "
          f"{cs.kernel_split(calls['pr1'], iters=50)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
