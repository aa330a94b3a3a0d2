"""Time variants of the fused backward pass (``csrc/mlp_fused_bwd.cu``)
against each other and against the package's pass on one GPU, in turns, at
the stock step's shapes.

    python3 tools/torch_fused_bwd_probe.py base= other=path/to/copy.cu:FLAG=1,X=2 ...

Each argument is ``name=[source:]flags``: the kernel source (default the
package's) compiled with ``-D`` flags (comma separated) into a library of
its own under ``build/fused_bwd_probe/`` with ``-Xptxas -v`` (the package's
``csrc/`` on the include path), whose registers, spills and wgmma notes
(C75xx) are printed. Kernel A's saving forward runs once at 1024 rays x
128 samples, width 256 (``RAYS=4096`` for k = 4), and then, in two rounds
(the second in reverse order), Kernel A's chain backward
(``mlp_kernel._chain_bwd``) on the package's pass and on each variant's:
each variant's gradients against the package's (relL2; input cotangents
bitwise or not), and the device time by the profiler of the whole
backward, with and without the weight gradients, and of its passes alone.
Without the weight gradients the package's backward takes its input-only
launch (``csrc/mlp_input_bwd.cu``, ``mlp_kernel.bwd_route``), timed as
"package input-only" beside the ten passes' input-only chain ("package
ten-pass input-only"); a variant's input-only time is its passes'. The
first round also prints the per-kernel device-time table of the first
variant's backward. Needs a CUDA device.
"""
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SOURCE = os.path.join(ROOT, "nope_nerf_tpu_torch", "csrc", "mlp_fused_bwd.cu")
OUT = os.path.join(ROOT, "build", "fused_bwd_probe")


def build_variants(variants):
    """{name: the variant's nnt_mlp_fused_bwd} for ``name=[source:]flags``
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
                 if ("C75" in line or "registers" in line or "spill" in line)
                 and "fused_bwd_kernel" in line or "Used" in line]
        print(f"{name}: nvcc rc {proc.returncode}\n  " + "\n  ".join(notes),
              flush=True)
        if proc.returncode:
            raise RuntimeError(f"{name} did not build:\n{err[-4000:]}")
        fn = ctypes.CDLL(lib).nnt_mlp_fused_bwd
        fn.argtypes = [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def profile_ms(fn, iters=20, match=None, table=False):
    """Device ms per call by the profiler: of every kernel, or of the
    kernels whose name holds ``match``; with ``table``, print the kernels'
    device ms per call."""
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
    rows = [(e.key, e.self_device_time_total / iters / 1e3, e.count / iters)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    if table:
        for key, ms, n in sorted(rows, key=lambda r: -r[1]):
            print(f"    {ms:8.4f} ms  x{n:5.1f}  {key[:100]}")
    return sum(ms for key, ms, _ in rows if match is None or match in key)


def main(argv):
    import torch

    from nope_nerf_tpu_torch import _build
    from nope_nerf_tpu_torch.models.nerf import init_nerf_params
    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    if not torch.cuda.is_available():
        print("torch_fused_bwd_probe: no CUDA device", file=sys.stderr)
        return 2
    _build.load_library()
    fns = build_variants(argv)
    dev = torch.device("cuda")
    cfg = {"model": {"hidden_dim": 256, "pos_enc_levels": 10,
                     "dir_enc_levels": 4},
           "rendering": {"white_background": False}}
    ws = mk.collect_weights(init_nerf_params(
        torch.Generator().manual_seed(0), cfg, dev))
    N, S = int(os.environ.get("RAYS", 1024)), 128
    gen = torch.Generator(device=dev).manual_seed(0)
    o = torch.randn((N, 3), device=dev, generator=gen) * 0.1
    r = torch.nn.functional.normalize(
        torch.randn((N, 3), device=dev, generator=gen), dim=1)
    z = torch.sort(torch.rand((N, S), device=dev, generator=gen) * 4 + 0.1,
                   1)[0]
    dl = torch.cat([z.diff(dim=1), torch.full((N, 1), 1e10, device=dev)], 1)
    static = (10, 4, "softplus", True, False, False, S)
    _, dims, sv = mk._composite_fwd(o, r, -r, z, dl, static, ws, True)
    enc, denc, feat, hr = sv[5:9]
    acts = sv[10:18]
    Wb, Wh = mk._weight_dicts(sv[18:])
    M = N * S
    g_raw = torch.randn((M, 4), device=dev, generator=gen) * 1e-3

    def bwd(chain, weight_grads=True):
        return chain(Wb, Wh, g_raw, enc, denc, S, feat, hr, acts, M, dims,
                     weight_grads)

    ref = bwd(mk._chain_bwd)
    real = mk.c_function
    times = {}

    def rel(a, b):
        return float(torch.linalg.vector_norm(a - b)
                     / torch.clamp_min(torch.linalg.vector_norm(b), 1e-30))

    try:
        for rnd, order in enumerate((list(fns), list(fns)[::-1])):
            mk.c_function = real
            times.setdefault("package", []).append(
                profile_ms(lambda: bwd(mk._chain_bwd)))
            times.setdefault("package input-only", []).append(
                profile_ms(lambda: bwd(mk._mlp_bwd, False)))
            times.setdefault("package ten-pass input-only", []).append(
                profile_ms(lambda: bwd(mk._chain_bwd, False)))
            for name in order:
                mk.c_function = (lambda n, s, f=fns[name]: f
                                 if n == "nnt_mlp_fused_bwd" else real(n, s))
                got = bwd(mk._chain_bwd)
                worst = max(rel(a, b) for a, b in zip(got[0], ref[0]))
                same = all(torch.equal(a, b) for a, b in
                           zip((*got[1], got[2]), (*ref[1], ref[2])))
                print(f"{name}: weight gradients max relL2 {worst:.3e} "
                      f"against the package's backward; input cotangents "
                      f"bitwise equal: {same}", flush=True)
                if rnd == 0 and name == order[0]:
                    print(f"  {name}: kernels of one backward (device ms, "
                          "launches):")
                    profile_ms(lambda: bwd(mk._chain_bwd), table=True)
                times.setdefault(name, []).append(
                    profile_ms(lambda: bwd(mk._chain_bwd)))
                times.setdefault(f"{name} passes", []).append(
                    profile_ms(lambda: bwd(mk._chain_bwd),
                               match="fused_bwd_kernel"))
                times.setdefault(f"{name} input-only", []).append(
                    profile_ms(lambda: bwd(mk._chain_bwd, False)))
    finally:
        mk.c_function = real
    for name, ms in times.items():
        print(f"{name}: device ms {['%.4f' % t for t in ms]}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"{card}; {N} rays x {S} samples, width 256")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
