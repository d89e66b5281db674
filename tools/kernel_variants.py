#!/usr/bin/env python3
"""Variants of the per-row Enhanced ERA kernel and of the fused round
kernel, timed on one card in one process.

    python3 tools/kernel_variants.py [out_dir]

Run from the root of a checkout, on a machine with an NVIDIA H100 (exits
1 without a CUDA device).  Every time is a CUDA-event median over
back-to-back launches (``chip_smoke.cuda_ms``); the card's name and power
limit are printed first.  It prints, and writes as JSON to
``<out_dir>/kernel_variants.json`` (default ``profile_out``):

- per-row ERA at whisper's (1536, 51968), float32 and bfloat16, in each
  layout of ``csrc/era_rows.cu``: one pass with clusters of 1, 2, 4 and 8
  blocks a row, and the multi-pass layout, each result held against the
  plain version (atol 1e-6, float32); and ``Tensor.copy_`` of the input,
  the practical floor of a pass that reads and writes it once;
- the multi-pass design's causes at (1536, 51968) float32
  (``tools/era_rows_causes.cu``): three reads or one, with or without
  the precise log, exp and division; and the multi-pass layout at 2112
  rows (two whole waves of its 1056 resident blocks) against 1536 (1.45
  waves), per row;
- the one-pass kernels' machine code (``cuobjdump -sass``): each loop's
  instructions, the instructions a value of the load, exp and write
  loops, and the time they take at the card's issue rate (4 warp
  instructions a cycle on each of 132 multiprocessors at the maximum SM
  clock) beside the byte bound;
- the fused round at the slice's (100, 1000, 10), delta + quant8 +
  sharpen, in tile layouts of several (clients a chunk, rows a tile), and
  in the rows layout (a warp a row, the kernel's layout for N past the
  tile layout); then in the plan's layout for each codec mode with and
  without sharpening.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

ERA_SHAPE = (1536, 51968)
ERA_WAVES_ROWS = 2112  # 2 x 1056 resident blocks of 256 threads
ROUND_TILES = ((100, 2), (100, 4), (100, 8), (100, 1), (128, 2), (64, 4))
SM_COUNT, SCHEDULERS, WARP = 132, 4, 32


def log(msg: str) -> None:
    print(msg, flush=True)


def max_sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], check=True, capture_output=True,
                         text=True, timeout=60).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def causes_lib():
    """The cause variants' library, built with the port's flags."""
    from repro_torch.kernels import runtime

    src = os.path.join(ROOT, "tools", "era_rows_causes.cu")
    lib = runtime.BUILD_DIR / "libera_rows_causes.so"
    runtime.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([runtime.nvcc(), *runtime.nvcc_flags("era_rows"), "-o", str(lib), src],
                   check=True, capture_output=True, text=True, timeout=600)
    h = ctypes.CDLL(str(lib))
    h.era_causes_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                    ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p]
    h.era_causes_launch.restype = ctypes.c_int
    return h


def era_variants(dev) -> dict:
    from repro_torch.kernels import era_kernel as ek

    out = {}
    B, N = ERA_SHAPE
    gen = torch.Generator(device=dev).manual_seed(9)
    z32 = torch.softmax(torch.randn(B, N, device=dev, generator=gen), -1)
    want = ek.enhanced_era_plain(z32, cs.BETA)
    for dtype in (torch.float32, torch.bfloat16):
        z = z32.to(dtype)
        o = torch.empty_like(z)
        b, _ = cs.bound_ms(z.element_size() * 2.0 * z.numel(), 8.0 * z.numel())
        for layout in (("onepass", 1), ("onepass", 2), ("onepass", 4), ("onepass", 8),
                       ("passes", 1)):
            def run(layout=layout, z=z, o=o):
                ek.launch_rows(z, o, cs.BETA, None, layout)

            run()
            torch.cuda.synchronize()
            err = float((o.float() - want).abs().max()) if dtype == torch.float32 else None
            ms = cs.cuda_ms(run)
            key = f"era {dtype} {layout[0]} cluster {layout[1]}"
            out[key] = dict(ms=ms, bound_ms=b, max_abs_err=err)
            log(f"{key}: {ms * 1e3:.2f} us (bound {b * 1e3:.2f} us"
                f"{f', max_abs_err {err!r}' if err is not None else ''})")
            if err is not None and err > cs.ERA_ATOL:
                raise AssertionError(f"{key}: max_abs_err {err}")
        ms = cs.cuda_ms(lambda z=z, o=o: o.copy_(z))
        out[f"era {dtype} copy_"] = dict(ms=ms, bound_ms=b)
        log(f"era {dtype} Tensor.copy_ of the input: {ms * 1e3:.2f} us (bound {b * 1e3:.2f} us)")
    del want

    h = causes_lib()
    o = torch.empty_like(z32)
    for passes, math in ((3, 1), (3, 0), (1, 1), (1, 0)):
        def run(passes=passes, math=math):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = h.era_causes_launch(z32.data_ptr(), o.data_ptr(), B, N, cs.BETA, passes,
                                      math, stream)
            if err:
                raise RuntimeError(f"era_causes: cudaError {err}")

        ms = cs.cuda_ms(run)
        key = f"era causes: {passes} read(s), {'precise math' if math else 'no math'}"
        out[key] = dict(ms=ms)
        log(f"{key}: {ms * 1e3:.2f} us")
    for rows in (B, ERA_WAVES_ROWS):
        zr = torch.softmax(torch.randn(rows, N, device=dev, generator=gen), -1)
        orr = torch.empty_like(zr)
        ms = cs.cuda_ms(lambda zr=zr, orr=orr: ek.launch_rows(zr, orr, cs.BETA, None,
                                                               ("passes", 1)))
        key = f"era passes at {rows} rows"
        out[key] = dict(ms=ms, us_per_row=ms * 1e3 / rows)
        log(f"{key}: {ms * 1e3:.2f} us, {ms * 1e6 / rows:.2f} ns a row")
        del zr, orr
    return out


def _loops(fn_sass: str):
    """[(start, end, instructions, opcode counts)] of the innermost loops
    of one function's SASS: ranges from a backward branch's target to the
    branch that hold no other backward branch (out-of-line code that
    branches back, such as a division's slow path, spans whole loops and
    is left out)."""
    ins = []
    for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", fn_sass):
        ins.append((int(m.group(1), 16), m.group(2).strip()))
    back = []
    for addr, text in ins:
        b = re.search(r"\bBRA\b[^0-9]*0x([0-9a-f]+)", text)
        if b and int(b.group(1), 16) < addr:
            back.append((int(b.group(1), 16), addr))
    loops = []
    for start, end in back:
        if any(start <= a < end for _, a in back):
            continue  # holds another loop's branch
        body = [t for a, t in ins if start <= a <= end]
        ops = {}
        for t in body:
            op = t.split()[1] if t.startswith("@") else t.split()[0]
            ops[op] = ops.get(op, 0) + 1
        loops.append((start, end, len(body), ops))
    return loops


def dump_sass(lib: str, out_dir: str) -> str:
    """``cuobjdump -sass`` of kernel library ``lib``, also written to
    ``<out_dir>/<lib>.sass``."""
    from repro_torch.kernels import runtime

    runtime.load(lib)
    cuobjdump = os.path.join(os.path.dirname(runtime.nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(runtime._lib_path(lib))],
                          capture_output=True, text=True, check=True, timeout=120).stdout
    with open(os.path.join(out_dir, f"{lib}.sass"), "w") as f:
        f.write(sass)
    return sass


def sass_per_value(clock_hz: float, out_dir: str) -> dict:
    """Instructions a value of the one-pass kernels' main loops, from
    their machine code: the load loop does 4 vectors of 4 (float32) or 8
    (bfloat16) values an iteration, the exp loop one value an exp
    (MUFU.EX2), the write loop one value a division (MUFU.RCP)."""
    sass = dump_sass("era_rows", out_dir)
    dump_sass("fused_round", out_dir)
    out = {}
    B, N = ERA_SHAPE
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        m = re.search(r"era_rows_onepassI(f|13__nv_bfloat16)Li(\d)E", fn.split("\n", 1)[0])
        if not m:
            continue
        dt, c = ("float" if m.group(1) == "f" else "bf16"), int(m.group(2))
        load_values = 16 if dt == "float" else 32
        phases = {}
        for start, end, n_ins, ops in _loops(fn):
            ex2, rcp = ops.get("MUFU.EX2", 0), ops.get("MUFU.RCP", 0)
            if ex2:
                phase, values = "exp", ex2
            elif rcp:
                phase, values = "write", rcp
            elif any(op.startswith("LDG") and op.endswith(".128") for op in ops):
                phase, values = "load", load_values
            else:
                continue
            if values > phases.get(phase, (0, 0, 0))[1]:
                phases[phase] = (n_ins, values, f"{start:#x}-{end:#x}")
        per_value = sum(n / v for n, v, _ in phases.values())
        issue_ms = per_value * B * N / (SM_COUNT * SCHEDULERS * WARP * clock_hz) * 1e3
        key = f"era_rows_onepass<{dt},{c}>"
        out[key] = dict(loops={p: dict(instructions=n, values=v, range=r)
                               for p, (n, v, r) in phases.items()},
                        instructions_per_value=per_value, issue_ms=issue_ms)
        log(f"sass {key}: " + ", ".join(f"{p} loop {n} instructions / {v} values ({r})"
                                         for p, (n, v, r) in sorted(phases.items()))
            + f"; {per_value:.2f} instructions a value, {issue_ms * 1e3:.1f} us at the issue "
            f"rate over {B}x{N}")
    return out


def round_variants(dev) -> dict:
    from repro_torch.kernels import round_kernel as rk
    from repro_torch.kernels.quant_kernel import _levels

    rng = np.random.default_rng(3)
    z, w, base = cs.slice_round_inputs(rng, dev)
    want = rk.fused_round_plain(z, w, cs.BETA, base, mode="delta", bits=8)
    out = {}
    for layout in ROUND_TILES + ("rows",):
        o = torch.empty_like(base)

        def run(layout=layout, o=o):
            rk.launch_round(z, w, base, o, mode="delta", levels=_levels(8), sharpen=True,
                            beta_val=cs.BETA, beta_source="python", layout=layout)

        run()
        torch.cuda.synchronize()
        err = float((o - want).abs().max())
        ms = cs.cuda_ms(run)
        key = f"fused_round {tuple(z.shape)} delta+quant8 layout {layout}"
        out[key] = dict(ms=ms, max_abs_err=err)
        log(f"{key}: {ms * 1e3:.2f} us, max_abs_err {err!r}")
        if err > cs.ROUND_ATOL:
            raise AssertionError(f"{key}: max_abs_err {err}")
    # what each step costs in the plan's layout: the codec and the sharpening
    for mode, bits in (("identity", None), ("quant", 8), ("delta", 8)):
        for sharpen in (False, True):
            o = torch.empty_like(base)
            ms = cs.cuda_ms(lambda mode=mode, bits=bits, sharpen=sharpen, o=o: rk.launch_round(
                z, w, base if mode == "delta" else None, o, mode=mode,
                levels=_levels(bits) if bits else 0.0, sharpen=sharpen, beta_val=cs.BETA,
                beta_source="python"))
            key = f"fused_round {tuple(z.shape)} {mode} bits={bits} sharpen={sharpen}"
            out[key] = dict(ms=ms)
            log(f"{key}: {ms * 1e3:.2f} us")
    return out


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device; this tool needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.kernels import runtime

    out_dir = argv[1] if len(argv) > 1 else os.path.join(ROOT, "profile_out")
    os.makedirs(out_dir, exist_ok=True)
    dev = torch.device("cuda")
    card = cs.card_line()
    log(card)
    t0 = time.perf_counter()
    runtime.build(["era_rows", "fused_round"])
    log(f"build {time.perf_counter() - t0:.1f} s")
    clock = max_sm_clock_hz()
    log(f"max SM clock {clock / 1e6:.0f} MHz")
    res = dict(card=card, max_sm_clock_hz=clock)
    res["round"] = round_variants(dev)
    res["era"] = era_variants(dev)
    res["sass"] = sass_per_value(clock, out_dir)
    with open(os.path.join(out_dir, "kernel_variants.json"), "w") as f:
        json.dump(res, f, indent=1)
    log(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
