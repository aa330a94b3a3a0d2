"""Time variants of the fused forward kernel (``csrc/mlp_fused_fwd.cu``)
against each other on one GPU, in turns, at the shapes the port runs.

    python3 tools/torch_fused_fwd_probe.py base= other=path/to/copy.cu:FLAG=1,X=2 ...

Each argument is ``name=[source:]flags``: the kernel source (default the
package's) compiled with ``-D`` flags (comma separated) into a library of
its own under ``build/fused_probe/`` with ``-Xptxas -v`` (the package's
``csrc/`` on the include path), whose registers,
spills and wgmma-serialisation warnings (C7511) are printed. Then, in two
rounds (the second in reverse order), Kernel A's forward
(``mlp_kernel._composite_fwd``) runs on each variant at width 256 and 128
samples: whether its outputs and saved tensors equal the package's
kernel's bit for bit at 1024 rays (a knockout variant will not) and its
outputs at the render's 16,384-ray chunk, and the variant kernel's device
time by the profiler: saving and not at 1024 rays, not saving at 16,384.

A variant that also exports ``nnt_fwd_stamps`` has its per-tile phase times
printed (:func:`phases`), at the render chunk without saves and at 1024
rays with saves. Such a variant is a scratch copy of the kernel whose
thread 0 of each consumer warpgroup of block 0 writes ``clock64`` at each
phase boundary of its first 128 tiles into ``__device__ unsigned long long
g_stamps[2][128][64]`` (the phase's label in order in a comma-separated
``const char* nnt_fwd_stamp_names()``), adds its cycles waiting on the
ring's full barriers into ``g_wait[2]`` and (clock64, globaltimer) at the
first and the last stamp into ``g_gt[4]``, and exports ``int
nnt_fwd_stamps(unsigned long long*)`` (the three arrays, in that order,
``cudaMemcpyFromSymbol``) and ``int nnt_fwd_stamps_reset()``. With ``TESTS=<pytest -k
expression>`` the card tests of tests/test_torch_cuda.py run first on the
package's own build. Needs a CUDA device.
"""
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SOURCE = os.path.join(ROOT, "nope_nerf_tpu_torch", "csrc", "mlp_fused_fwd.cu")
OUT = os.path.join(ROOT, "build", "fused_probe")
# the stamped copies' buffer: 2 warpgroups x 128 tiles x 64 stamps, the two
# warpgroups' ring waits, (clock, globaltimer) at the first and last stamp
ST_TILES, ST_N = 128, 64
RENDER_RAYS, STOCK_RAYS, S = 16384, 1024, 128


def build_variants(variants):
    """{name: the variant's nnt_mlp_fused_fwd} for ``name=[source:]flags``
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
             "-I", _build.CSRC_DIR, "-shared", "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        _, err = proc.communicate()
        notes = [line.strip()[:160] for line in err.splitlines()
                 if "C75" in line or "registers" in line or "spill" in line]
        print(f"{name}: nvcc rc {proc.returncode}\n  " + "\n  ".join(notes),
              flush=True)
        if proc.returncode:
            raise RuntimeError(f"{name} did not build:\n{err[-4000:]}")
        dll = ctypes.CDLL(lib)
        fn = dll.nnt_mlp_fused_fwd
        fn.argtypes = [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
        fn.dll = dll
        fns[name] = fn
    return fns


def phases(fn, run):
    """Block 0's per-tile phase times (ns, mean over its tiles but the first
    and the last) of one ``run`` of a stamped variant, per consumer
    warpgroup: each stamp's label and the time since the stamp before it
    (the first, ``start``, the time since the tile before ended), and the
    warpgroups' waits on the weight ring's full barriers over the launch."""
    import numpy as np
    import torch

    dll = fn.dll
    dll.nnt_fwd_stamps.argtypes = [ctypes.c_void_p]
    dll.nnt_fwd_stamp_names.restype = ctypes.c_char_p
    names = dll.nnt_fwd_stamp_names().decode().split(",")
    run()
    torch.cuda.synchronize()
    if dll.nnt_fwd_stamps_reset():
        raise RuntimeError("nnt_fwd_stamps_reset failed")
    run()
    torch.cuda.synchronize()
    buf = np.zeros(2 * ST_TILES * ST_N + 6, np.uint64)
    if dll.nnt_fwd_stamps(buf.ctypes.data):
        raise RuntimeError("nnt_fwd_stamps failed")
    st = buf[:2 * ST_TILES * ST_N].reshape(2, ST_TILES, ST_N).astype(
        np.float64)[:, :, :len(names)]
    wait = buf[2 * ST_TILES * ST_N:2 * ST_TILES * ST_N + 2].astype(
        np.float64)
    c0, g0, c1, g1 = buf[-4:].astype(np.float64)
    ns_per_clk = (g1 - g0) / (c1 - c0)
    tiles = int(np.sum(st[0, :, 0] > 0))
    out = {"tiles": tiles, "ghz": 1 / ns_per_clk,
           "tile_ns": float(np.mean(np.diff(st[0, :tiles, 0]))
                            * ns_per_clk) if tiles > 1 else None,
           "ring_wait_ns_per_tile": [float(w * ns_per_clk / max(tiles, 1))
                                     for w in wait]}
    for wg in range(2):
        s = st[wg, :tiles]
        d = np.diff(s, axis=1)
        start = s[1:, 0] - s[:-1, -1]  # the tile before's end to this start
        body = d[1:-1] if tiles > 3 else d
        mean = np.mean(body, axis=0) * ns_per_clk
        out[f"wg{wg}"] = {"start": float(np.mean(start[1:-1] if tiles > 3
                                                 else start) * ns_per_clk),
                          **{n: round(float(v), 1)
                             for n, v in zip(names[1:], mean)}}
    return out


def kernel_ms(fn, iters=30):
    """Device ms per call of the fused kernel alone, by the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "fused_fwd_kernel" in e.key) / iters / 1e3


def main(argv):
    import torch

    from nope_nerf_tpu_torch import _build
    from nope_nerf_tpu_torch.models.nerf import init_nerf_params
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    if not torch.cuda.is_available():
        print("torch_fused_fwd_probe: no CUDA device", file=sys.stderr)
        return 2
    _build.load_library()
    fns = build_variants(argv)
    if os.environ.get("TESTS"):
        run = subprocess.run(
            [sys.executable, "-m", "pytest", "--noconftest", "-p",
             "no:cacheprovider", "-m", "cuda", "-q",
             os.path.join(ROOT, "tests", "test_torch_cuda.py"), "-k",
             os.environ["TESTS"]], capture_output=True, text=True)
        print(run.stdout[-2500:], flush=True)
    dev = torch.device("cuda")
    cfg = {"model": {"hidden_dim": 256, "pos_enc_levels": 10,
                     "dir_enc_levels": 4},
           "rendering": {"white_background": False}}
    ws = mk.collect_weights(init_nerf_params(
        torch.Generator().manual_seed(0), cfg, dev))
    static = (10, 4, "softplus", True, False, False, S)

    def inputs(N):
        gen = torch.Generator(device=dev).manual_seed(N)
        o = torch.randn((N, 3), device=dev, generator=gen) * 0.1
        r = torch.nn.functional.normalize(
            torch.randn((N, 3), device=dev, generator=gen), dim=1)
        z = torch.sort(torch.rand((N, S), device=dev, generator=gen) * 4
                       + 0.1, 1)[0]
        dl = torch.cat([z.diff(dim=1), torch.full((N, 1), 1e10,
                                                  device=dev)], 1)
        return o, r, -r, z, dl

    stock, render = inputs(STOCK_RAYS), inputs(RENDER_RAYS)
    ref = mk._composite_fwd(*stock, static, ws, True)
    ref_render = mk._composite_fwd(*render, static, ws, False)[0]
    cases = {"stock_save": (stock, True), "stock_nosave": (stock, False),
             "render_nosave": (render, False)}
    real = mk.c_function
    times = {}
    try:
        for order in (list(fns), list(fns)[::-1]):
            for name in order:
                mk.c_function = (lambda n, s, f=fns[name]: f
                                 if n == "nnt_mlp_fused_fwd" else real(n, s))
                got = mk._composite_fwd(*stock, static, ws, True)
                same = (all(torch.equal(a, b) for a, b in zip(got[0], ref[0]))
                        and all(torch.equal(a, b) for a, b in
                                zip(got[2][7:18], ref[2][7:18])))
                got_r = mk._composite_fwd(*render, static, ws, False)[0]
                same_r = all(torch.equal(a, b)
                             for a, b in zip(got_r, ref_render))
                print(f"{name}: bitwise equal to the package's kernel: "
                      f"stock outputs and saves {same}, render chunk outputs "
                      f"{same_r}", flush=True)
                for case, (args, save) in cases.items():
                    times.setdefault((name, case), []).append(kernel_ms(
                        lambda: mk._composite_fwd(*args, static, ws, save),
                        iters=30 if args is stock else 5))
        for name, fn in fns.items():
            if not hasattr(fn.dll, "nnt_fwd_stamps"):
                continue
            mk.c_function = (lambda n, s, f=fn: f
                             if n == "nnt_mlp_fused_fwd" else real(n, s))
            for case in ("render_nosave", "stock_save"):
                args, save = cases[case]
                print(f"{name} phases {case}: " + json.dumps(phases(
                    fn, lambda: mk._composite_fwd(*args, static, ws, save))),
                    flush=True)
    finally:
        mk.c_function = real
    for (name, case), ms in times.items():
        print(f"{name} {case}: kernel device ms {ms}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
