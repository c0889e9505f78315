"""Ablations of the flash-attention backward's main kernel on one CUDA card.

    python3 flash_bwd_ablations.py

Builds copies of `voxe_tpu_torch/csrc/flash_attn_bwd.cu` with one part of
the main kernel removed or changed, in a temporary directory (the repo's
source is not touched and has no switch for any of them), prints ptxas'
registers and spills of each copy's main kernel, holds the unchanged copy
against the plain backward, then times every copy's three launches
(torch.profiler device time) and the wrapper (CUDA events), in the order
given and then reversed, beside SDPA's backward. The copies other than
`as_built` and `role_by_division` compute wrong gradients on purpose: they
say what a part costs, not what the kernel computes.

  as_built          the source as it is
  role_by_division  the warp role from threadIdx.x / 128 instead of a shuffle
  no_reduce         no bulk reduce-add of the dQ partials
  no_dq_stage       neither the dQ partials' staging nor their reduce-add
  no_exp            P^T from the scaled score without its exponential
  no_ds_store       dS^T not written to shared memory (dQ reads stale data)
  mma_only          no exponentials, no dS^T stores, no dQ staging or reduce

Exits non-zero without a card. Imports nothing from JAX.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

from voxe_tpu_torch.ops import cuda_build
from voxe_tpu_torch.ops import flash_attention as fa

SOURCE = cuda_build.CSRC_DIR / "flash_attn_bwd.cu"
SHAPES = ((2, 4096, 5, 64), (2, 4096, 5, 128), (1, 4096, 33, 64))  # main; d = 128; 1056 blocks = 8 full waves
STAGE_START = "    // the partial into the staging buffer in register order (pair i of\n"
STAGE_END = "    wgmma_wait<0>();\n    reg_fence(dk_acc);\n"
DS_STORES = ('      asm volatile("st.shared.u32 [%0], %1;\\n" ::"r"(at), "r"(ds[2 * jj]) : "memory");\n'
             '      asm volatile("st.shared.u32 [%0], %1;\\n" ::"r"(at + 8 * kRowBytes), "r"(ds[2 * jj + 1]) : '
             '"memory");\n')
EDITS = {
    "as_built": [],
    "role_by_division": [("__shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0)",
                          "static_cast<int>(threadIdx.x) / 128")],
    "no_reduce": [("      bulk_reduce_add(dq_bh", "      if (j < 0) bulk_reduce_add(dq_bh")],
    "no_dq_stage": [(STAGE_START, "    if (j < 0) {\n" + STAGE_START), (STAGE_END, "    }\n" + STAGE_END)],
    "no_exp": [("ex2(fmaf(", "(fmaf(")],
    "no_ds_store": [(DS_STORES, "")],
}
EDITS["mma_only"] = EDITS["no_dq_stage"] + EDITS["no_exp"] + EDITS["no_ds_store"]


def variant_source(edits) -> str:
    text = SOURCE.read_text()
    for old, new in edits:
        if old not in text:
            raise AssertionError(f"the source has changed: no {old[:60]!r}")
        text = text.replace(old, new)
    return text


def build(name: str, workdir: Path):
    src = workdir / f"{name}.cu"
    src.write_text(variant_source(EDITS[name]))
    lib = workdir / f"lib{name}.so"
    cmd = [cuda_build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xptxas", "-v",
           "-shared", "-Xcompiler", "-fPIC", "-o", str(lib), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stdout}\n{proc.stderr}")
    fn = ctypes.CDLL(str(lib)).voxe_flash_attn_bwd
    fn.argtypes, fn.restype = fa._LIB_BWD.argtypes, ctypes.c_int
    summary = cuda_build.ptxas_summary(proc.stdout + proc.stderr)
    report = {("d=128" if "ILi128" in k else "d=64"): v for k, v in summary.items() if "16flash_bwd_kernel" in k}
    return name, fn, report


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def launch_split_ms(fn, calls: int = 5) -> dict:
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    names = {"flash_bwd_pre_kernel": "pre", "flash_bwd_kernel": "main", "flash_bwd_post_kernel": "post"}
    return {label: e.device_time_total / e.count / 1e3 for e in prof.key_averages()
            for kernel, label in names.items() if f"::{kernel}<" in e.key}


def use(fn) -> None:
    """Route the wrapper's backward through one copy's entry point."""
    fa._LIB_BWD._fn = fn


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_bwd_ablations: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {card}", flush=True)
    fa.build()
    with tempfile.TemporaryDirectory(prefix="flash_bwd_ablations_") as tmp, ThreadPoolExecutor(len(EDITS)) as pool:
        built = list(pool.map(lambda n: build(n, Path(tmp)), EDITS))
        fns = {}
        for name, fn, report in built:
            fns[name] = fn
            for d, props in sorted(report.items()):
                print(f"[ptxas] variant={name} {d} " + " ".join(f"{k}={v}" for k, v in props.items()), flush=True)
        g = torch.Generator(device=dev).manual_seed(0)
        for shape, lk in (((2, 1000, 3, 64), 777), ((1, 2500, 2, 128), 1000), ((2, 4096, 5, 64), None)):
            kv = shape if lk is None else (shape[0], lk, *shape[2:])
            q, do = (torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16) for _ in range(2))
            k, v = (torch.randn(kv, generator=g, device=dev, dtype=torch.bfloat16) for _ in range(2))
            out, lse = fa.flash_attention_with_lse(q, k, v)
            refs = fa.flash_attention_backward_reference(q.float(), k.float(), v.float(), out.float(), lse, do)
            for name in ("as_built", "role_by_division"):
                use(fns[name])
                grads = fa.flash_attention_backward(q, k, v, out, lse, do)
                rel = [float((a.float() - r).abs().max() / r.abs().max()) for a, r in zip(grads, refs)]
                print(f"[check] variant={name} shape={list(shape)} lk={kv[1]} rel_dq_dk_dv={rel}", flush=True)
                if max(rel) >= 2e-2:
                    raise AssertionError(f"{name} disagrees with the plain backward: {rel}")
        order = list(EDITS) + list(EDITS)[::-1]
        for shape in SHAPES:
            q, k, v, do = (torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16) for _ in range(4))
            out, lse = fa.flash_attention_with_lse(q, k, v)
            qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True) for x in (q, k, v))
            sdpa_out = F.scaled_dot_product_attention(qt, kt, vt)
            dot = do.transpose(1, 2).contiguous()
            wrapper, split, sdpa = {n: [] for n in EDITS}, {}, []
            for name in order:
                use(fns[name])
                wrapper[name].append(time_ms(lambda: fa.flash_attention_backward(q, k, v, out, lse, do)))
                sdpa.append(time_ms(lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dot, retain_graph=True)))
            for name in EDITS:  # one profile a copy (a launch the profile misses shows as None)
                use(fns[name])
                split[name] = launch_split_ms(lambda: fa.flash_attention_backward(q, k, v, out, lse, do))
            for name in EDITS:
                print(f"[time] variant={name} shape={list(shape)} wrapper_ms={wrapper[name]} "
                      + " ".join(f"{k}_ms={split[name].get(k)}" for k in ("main", "pre", "post")), flush=True)
            print(f"[time] sdpa_backward shape={list(shape)} ms={sdpa}", flush=True)
            del sdpa_out, qt, kt, vt
    print(f"[card] {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
