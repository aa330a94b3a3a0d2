"""Time variants of the fused forward kernel (``csrc/mlp_fused_fwd.cu``)
against each other on one GPU, in turns, at the stock step's shapes.

    python3 tools/torch_fused_fwd_probe.py base= other=path/to/copy.cu:FLAG=1,X=2 ...

Each argument is ``name=[source:]flags``: the kernel source (default the
package's) compiled with ``-D`` flags (comma separated) into a library of
its own under ``build/fused_probe/`` with ``-Xptxas -v`` (the package's
``csrc/`` on the include path), whose registers,
spills and wgmma-serialisation warnings (C7511) are printed. Then, in two
rounds (the second in reverse order), Kernel A's saving forward
(``mlp_kernel._composite_fwd``) runs on each variant at 1024 rays x 128
samples, width 256: whether its outputs and saved tensors equal the
layer-by-layer forward's bit for bit (a knockout variant will not), and the
variant kernel's device time by the profiler, saving and not. With
``TESTS=<pytest -k expression>`` the card tests of tests/test_torch_cuda.py
run first on the package's own build. Needs a CUDA device.
"""
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SOURCE = os.path.join(ROOT, "nope_nerf_tpu_torch", "csrc", "mlp_fused_fwd.cu")
OUT = os.path.join(ROOT, "build", "fused_probe")


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
        fn = ctypes.CDLL(lib).nnt_mlp_fused_fwd
        fn.argtypes = [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


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
    N, S = 1024, 128
    gen = torch.Generator(device=dev).manual_seed(0)
    o = torch.randn((N, 3), device=dev, generator=gen) * 0.1
    r = torch.nn.functional.normalize(
        torch.randn((N, 3), device=dev, generator=gen), dim=1)
    z = torch.sort(torch.rand((N, S), device=dev, generator=gen) * 4 + 0.1,
                   1)[0]
    dl = torch.cat([z.diff(dim=1), torch.full((N, 1), 1e10, device=dev)], 1)
    static = (10, 4, "softplus", True, False, False, S)
    ref = mk._composite_fwd_layered(o, r, -r, z, dl, static, ws, True)
    real = mk.c_function
    times = {}
    try:
        for order in (list(fns), list(fns)[::-1]):
            for name in order:
                mk.c_function = (lambda n, s, f=fns[name]: f
                                 if n == "nnt_mlp_fused_fwd" else real(n, s))
                got = mk._composite_fwd(o, r, -r, z, dl, static, ws, True)
                same = (all(torch.equal(a, b) for a, b in zip(got[0], ref[0]))
                        and all(torch.equal(a, b) for a, b in
                                zip(got[2][7:18], ref[2][7:18])))
                print(f"{name}: outputs and saves bitwise equal to the "
                      f"layer-by-layer forward: {same}", flush=True)
                for save in (True, False):
                    times.setdefault((name, save), []).append(kernel_ms(
                        lambda: mk._composite_fwd(o, r, -r, z, dl, static,
                                                  ws, save)))
    finally:
        mk.c_function = real
    for (name, save), ms in times.items():
        print(f"{name} save={save}: kernel device ms {ms}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
