"""Where the time of the stream block's wide kernels goes, on one NVIDIA card.

    python -m gaitpd_torch.tools.stream_block_wide_parts [--seed 0]

Builds gaitpd_torch/csrc/stream_block.cu several times with parts of the
wide kernels' work cut out of a copy of the source (the cuts below, each
matched against the source's text, so a changed source fails loudly), and
times each build at FOCAL's shape (1024 windows of 64 frames x 320
channels, GELU) by the device time of its kernels under torch.profiler:

  - the conv kernel (the forward, and the backward's g_z kernel): whole;
    its cp.async copies alone; its FMAs alone; with 16-channel chunks; with
    3 and 4 buffers;
  - the gx/gw kernel of the backward: whole; its copies alone; without its
    gw warps' work; without its gx warps' work; without its gx stores.

A build with a part cut out computes a wrong result: only the full builds'
errors against the plain versions are checked. The card's name and power
limit are printed beside the times. The builds go to
gaitpd_torch/_build/parts/ (gitignored).
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from gaitpd_torch.ops import _build
from gaitpd_torch.ops import stream_block as sb

CONV_COPIES = """      wide_stage_x<VEC>(x, buf, b0, nwin, cin, c * kWideChunk);
      wide_stage_w<VEC>(w, buf + windows * kWideXWin, cin, c * kWideChunk);
"""
CONV_FMAS = "      for (int q = s; q < nq; q += splits) {"
GRAD_GW = "      if (wb0 + rd * kWideGradWindows + slot < wb1) {"
GRAD_GX = "      for (int h = 0; h < 2 && win < wb1 && c0 + 16 * h < cin; ++h) {"
GRAD_GX_STORE = "            *reinterpret_cast<float4*>(out + j * cin) ="
CHUNK = "constexpr int kWideChunk = 32;"
STAGES = "constexpr int kConvStages = 2;"

# (name, [(text, replacement)]): a runtime condition that never holds keeps
# the compiler from removing the work around the part that is cut
VARIANTS = {
    "full": [],
    "conv_copies_only": [(CONV_FMAS, CONV_FMAS.replace("q < nq;", "q < nq && nq < 0;"))],
    "conv_fmas_only": [(CONV_COPIES, "")],
    "conv_chunk16": [(CHUNK, CHUNK.replace("32", "16"))],
    "conv_stages3": [(STAGES, STAGES.replace("2", "3"))],
    "conv_stages4": [(STAGES, STAGES.replace("2", "4"))],
    "grad_copies_only": [(GRAD_GW, GRAD_GW.replace("< wb1", "< wb1 && cin < 0")),
                         (GRAD_GX, GRAD_GX.replace("< cin;", "< cin && cin < 0;"))],
    "grad_without_gw": [(GRAD_GW, GRAD_GW.replace("< wb1", "< wb1 && cin < 0"))],
    "grad_without_gx": [(GRAD_GX, GRAD_GX.replace("< cin;", "< cin && cin < 0;"))],
    "grad_without_gx_stores": [(GRAD_GX_STORE, "            if (batch < 0) "
                                + GRAD_GX_STORE.lstrip())],
}


def cut(name, source):
    """The source with VARIANTS[name]'s parts cut out; raises where the source
    does not hold a cut's text exactly once."""
    text = source
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the source no longer holds {old!r} once")
        text = text.replace(old, new)
    return text


def build(name, source, out_dir):
    text = cut(name, source)
    src = out_dir / f"{name}.cu"
    src.write_text(text)
    lib = out_dir / f"lib{name}.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stdout}{proc.stderr}")
    return lib


def kernel_ms(fn, reps=20):
    """Device time per call of each kernel, by name, under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / reps for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}


def short(name):
    for part in ("wide_grad_kernel", "wide_kernel", "reduce_partials", "reduce_slices"):
        if part in name:
            return part
    return name[:40]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("stream_block_wide_parts: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    out_dir = _build.BUILD_DIR / "parts"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = (_build.CSRC / "stream_block.cu").read_text()
    with ThreadPoolExecutor(max_workers=len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(lambda name: build(name, source, out_dir), VARIANTS)))
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(args.seed)
    bsz, t, cin, k, cout, t_out, act = 1024, 64, 320, 3, 16, 8, 1  # GELU
    x = torch.from_numpy(rng.normal(size=(bsz, t, cin)).astype(np.float32)).to(dev)
    w = torch.from_numpy((rng.normal(size=(k, cin, cout)) / np.sqrt(k * cin))
                         .astype(np.float32)).to(dev)
    b = torch.from_numpy((rng.normal(size=cout) * 0.1).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.normal(size=(bsz, t_out, cout)).astype(np.float32)).to(dev)
    want = sb.stream_block_reference(x, w, b, t_out, "gelu")
    want_b = sb.stream_block_backward_reference(x, w, b, g, t_out, "gelu")
    out = torch.empty(want.shape, device=dev)  # contiguous, as the kernel writes it
    for name, path in libs.items():
        fwd, rows, bwd, _, _ = sb._bind(ctypes.CDLL(str(path)))
        stream = torch.cuda.current_stream().cuda_stream
        n_rows = rows(1, bsz, t, cin, cout, k, t_out)
        grads = [torch.empty_like(v) for v in (x, w, b)]
        partial = torch.empty((n_rows, k * cin * cout + cout), device=dev)
        gz = torch.empty((bsz, t, cout), device=dev)

        def forward():
            err = fwd(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), bsz, t, cin,
                      cout, k, t_out, act, sb.WIDE, stream)
            assert err == 0, err

        def backward():
            err = bwd(x.data_ptr(), w.data_ptr(), b.data_ptr(), g.data_ptr(),
                      *(v.data_ptr() for v in grads), partial.data_ptr(), gz.data_ptr(),
                      bsz, t, cin, cout, k, t_out, act, sb.BWD_WIDE, stream)
            assert err == 0, err

        line = f"[parts] {card}: {name}:"
        if name.startswith("conv") or name == "full":
            times = kernel_ms(forward)
            line += f" forward {' '.join(f'{short(n)} {v:.4f}' for n, v in times.items())} ms;"
        if name.startswith("grad") or name == "full":
            times = kernel_ms(backward)
            line += f" backward {' '.join(f'{short(n)} {v:.4f}' for n, v in times.items())} ms;"
        if name == "full":
            errs = [(out - want).abs().max().item()] + [
                (p - q).abs().max().item() / max(1.0, q.abs().max().item())
                for p, q in zip(grads, want_b)]
            line += f" errors forward/gx/gw/gb {['%.2e' % e for e in errs]}"
            if max(errs) > 1e-5:
                raise RuntimeError(f"the full build disagrees with the plain version: {errs}")
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
