"""Time variants of Kernel A's encoding backward (``encode_bwd_staged`` in
``csrc/mlp_composite.cu``) against each other and against the package's
kernel, on one GPU, in turns.

    python3 tools/torch_encode_bwd_probe.py base= other=path/to/copy.cu:FLAG=1 ...

Each argument is ``name=[source:]flags``: the source (default the
package's ``mlp_composite.cu``) compiled with ``-D`` flags (comma
separated) into a library of its own under ``build/encode_bwd_probe/``
with ``-Xptxas -v``, whose registers, stack and spills of the staged kernel
are printed. On seeded inputs at the stock shapes (1024 rays x 128
samples), at k = 4 (4096 rays) and at the recovery scripts' 1024 x 64
(the position and direction encodings' cotangents in rows padded to 8
columns, as the chain backward leaves them), each variant's outputs are
compared with the package's kernel (``mlp_kernel.encode_bwd``; bitwise or
not) and with the plain version (``encode_bwd_reference``, relL2), and its
device time by the profiler is taken in two rounds, the second in reverse
order, the package's kernel among them. Needs a CUDA device.
"""
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SOURCE = os.path.join(ROOT, "nope_nerf_tpu_torch", "csrc", "mlp_composite.cu")
OUT = os.path.join(ROOT, "build", "encode_bwd_probe")
SHAPES = (("stock", 1024, 128), ("k4", 4096, 128), ("recovery", 1024, 64))


def build_variants(variants):
    """{name: the variant's nnt_encode_bwd_staged} for ``name=[source:]flags``
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
        lines = err.splitlines()
        notes = [lines[i + j].strip()[:120] for i, line in enumerate(lines)
                 if "encode_bwd_staged" in line for j in (1, 2)
                 if i + j < len(lines)]
        print(f"{name}: nvcc rc {proc.returncode}; " + " | ".join(notes),
              flush=True)
        if proc.returncode:
            raise RuntimeError(f"{name} did not build:\n{err[-4000:]}")
        fn = ctypes.CDLL(lib).nnt_encode_bwd_staged
        fn.argtypes = [ctypes.c_void_p if c == "p" else ctypes.c_int
                       for c in "pppppipipipppiiiip"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def device_ms(fn, iters=20):
    """Device ms per call by the profiler (every kernel of ``fn``)."""
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
               if e.device_type == torch.autograd.DeviceType.CUDA) / iters / 1e3


def inputs(N, S, dev, seed=0):
    """Per-ray geometry, z, and the cotangents in padded rows: the
    argument tuple of ``mlp_kernel.encode_bwd``."""
    import torch

    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    gen = torch.Generator(device=dev).manual_seed(seed)
    M = N * S
    rays = torch.nn.functional.normalize(
        torch.randn((N, 3), generator=gen, device=dev), dim=1)
    origins = (torch.randn((1, 3), generator=gen, device=dev) * 0.1).expand(
        N, 3).contiguous()
    z = torch.sort(torch.rand((N, S), generator=gen, device=dev) * 3.5 + 0.5,
                   dim=1).values

    def cot(k):
        buf = torch.empty((M, mk._pad8(k)), device=dev)
        buf[:, :k] = torch.randn((M, k), generator=gen, device=dev) * 1e-3
        return buf[:, :k]

    return (origins, rays, -rays, z, cot(63), cot(63), cot(27), 10, 4)


def main(argv):
    import torch

    from nope_nerf_tpu_torch.ops.kernels import mlp_kernel as mk

    dev = torch.device("cuda", 0)
    fns = build_variants(argv)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(out)
    for label, N, S in SHAPES:
        args = inputs(N, S, dev)
        o, r, d, z, ge1, ge2, gd, l_pos, l_dir = args
        want = mk.encode_bwd(*args)
        plain = mk.encode_bwd_reference(*args)

        def call(fn):
            outs = [torch.empty((N, 3), device=dev) for _ in range(3)]

            def run():
                err = fn(*(t.data_ptr() for t in (o, r, d, z, ge1)),
                         ge1.stride(0), ge2.data_ptr(), ge2.stride(0),
                         gd.data_ptr(), gd.stride(0),
                         *(t.data_ptr() for t in outs), N, S, l_pos, l_dir,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"cudaError {err}")
            return run, outs

        runs = {}
        for name, fn in fns.items():
            run, outs = call(fn)
            run()
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(outs, want))
            rel = max(float(torch.linalg.vector_norm(a - b)
                            / torch.linalg.vector_norm(b))
                      for a, b in zip(outs, plain))
            runs[name] = (run, same, rel)
        runs["package"] = (lambda: mk.encode_bwd(*args), True, None)
        times = {name: [] for name in runs}
        for order in (list(runs), list(runs)[::-1]):
            for name in order:
                times[name].append(device_ms(runs[name][0]))
        print(f"{label} {N} x {S}: " + "; ".join(
            f"{name} {sum(t) / 2:.4f} ms ({t[0]:.4f}, {t[1]:.4f}; bitwise "
            f"to the package's {runs[name][1]}, relL2 to plain "
            f"{runs[name][2]})" for name, t in times.items()),
            flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or ["base="])
