#!/usr/bin/env python3
"""Where the WKV kernels' time goes, on one NVIDIA GPU, with no profiler
that reads inside a kernel: time ``csrc/wkv.cu`` (or, with ``--bwd``,
``csrc/wkv_bwd.cu``) with one step of its chunk loop taken out at a
time.

    python3 scripts/wkv_ablation.py [--heads 40 33]
    python3 scripts/wkv_ablation.py --bwd [--src CHECKOUT] [--label X]

Each variant is the kernel's source with one text edit, built by
``nvcc`` with the port's flags into ``.torch_ext_build/ablation/``.  The
edits match lines of the source exactly, so they follow the kernel's
text: an edit to one of those lines must be made here too (the script
fails, naming the edit, when the source no longer has it).  A variant
computes a wrong result and is only timed.

The forward (``EDITS``), at [4, 3072, H, 64] for each H of ``--heads``
(40 is rwkv6-3b's: 160 blocks on the card's 132 SMs; 33 gives 132
blocks, one an SM), ``chip_smoke.py``'s inputs (seed 93):

  full        the kernel as it is;
  no_copies   step 1: no cp.async copies (the barriers stay);
  no_decays   step 2: no log-space decays, decayed rows or A's diagonal;
  no_A        step 3: no pairs of A;
  no_y        step 4, first half: no y from the state entering the chunk;
  no_state    step 5: no state update.

The backward (``--bwd``), at the rwkv6-3b train shape [16, 256, 40, 64],
``chip_smoke.py``'s inputs (seed 99) and the chunk states K5 saves from
them.  ``--src CHECKOUT`` takes ``wkv_bwd.cu`` from another checkout (an
unpacked parent commit); the edits are picked by the design the source
has: ``BWD_EDITS`` for the tensor-core design, ``BWD_EDITS_FIRST`` for
the first one (a loop of a thread over shared memory a product):

  full         the kernel as it is;
  no_loads     the chunk's tiles and its saved state not loaded
               (no_tile_loads, no_state_loads: one of the two);
  no_products  no chunk products: B, SD, GV, X and dv's two terms;
  no_A         no pairs of the forward's A;
  no_drdkdw    no dr, dk, dw block;
  no_G         no update of G.

Prints each variant's median per-call time by CUDA events
(``chip_smoke.time_ms``) and the full kernel's time less the variant's,
the card's name and power limit, then one JSON object as the last line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

EDITS = {
    "full": [],
    "no_copies": [(
        "      cp_async16(sa + dst[m], in ? src[m] + (size_t)t0 * step : r, "
        "in);", "")],
    "no_decays": [("    if (tid < 4 * HD) {", "    if (tid < 0) {")],
    "no_A": [("      if (pair < kPairs) {\n        const float *ra",
              "      if (pair < 0) {\n        const float *ra")],
    "no_y": [("      yacc[t] = dot_rows<RPT>(rdec + t * RS + g * RPT, S);",
              "      yacc[t] = 0.f;")],
    "no_state": [(
        "    for (int i = 0; i < RPT; ++i) S[i] *= sdec[g * RPT + i];\n"
        "#pragma unroll\n    for (int t = 0; t < kL; ++t) {",
        "    for (int t = 0; t < 0; ++t) {")],
}

# csrc/wkv_bwd.cu, the tensor-core design
BWD_EDITS = {
    "full": [],
    "no_loads": [
        ("      cp_async16(sa + 4u * (a * C::kTile + t * RS + c),\n"
         "                 in ? p + base + (size_t)(t0 + t) * step + c : r, "
         "in);", ""),
        ("        const float2 x = ld2(sp + 8 * i);",
         "        const float2 x = make_float2(0.f, 0.f);")],
    "no_tile_loads": [
        ("      cp_async16(sa + 4u * (a * C::kTile + t * RS + c),\n"
         "                 in ? p + base + (size_t)(t0 + t) * step + c : r, "
         "in);", "")],
    "no_state_loads": [
        ("        const float2 x = ld2(sp + 8 * i);",
         "        const float2 x = make_float2(0.f, 0.f);")],
    "no_products": [
        ("    if (wp < NT) {                   // SD, GV, X",
         "    if (wp < 0) {"),
        ("    if (wp >= C::kWarps - 2) {       // B", "    if (wp < 0) {"),
        ("    if (wp < NT) {                   // dv", "    if (wp < 0) {")],
    "no_A": [("const bool is_pair = pair < kPairs,",
              "const bool is_pair = false,")],
    "no_drdkdw": [("      auto grads_at = [&](int t) {",
                   "      auto grads_at = [&](int t) {\n        if (t >= 0) return;")],
    "no_G": [("    const bool gw = tile0 < C::kGTiles;",
              "    const bool gw = false;")],
}

# csrc/wkv_bwd.cu as first written (a thread's loop over shared memory
# for every product)
BWD_EDITS_FIRST = {
    "full": [],
    "no_loads": [
        ("      const bool in = t0 + t < T;\n"
         "      const size_t off = base + (size_t)(t0 + t) * step + x;",
         "      const bool in = false;\n"
         "      const size_t off = base + (size_t)(t0 + t) * step + x;"),
        ("        S0[(i / HD) * RS + i % HD] = sp[i];",
         "        S0[(i / HD) * RS + i % HD] = 0.f;")],
    "no_products": [
        ("      for (int j = 0; j < HD; ++j) acc += dys[t * RS + j] * "
         "vs[s * RS + j];", ""),
        ("      for (int j = 0; j < HD; ++j) {\n"
         "        sd += S0[d * RS + j] * dys[t * RS + j];\n"
         "        gv += G[d * RS + j] * vs[t * RS + j];\n      }", ""),
        ("      for (int j = 0; j < HD; ++j) acc += G[d * RS + j] * "
         "S0[d * RS + j];", ""),
        ("      for (int d = 0; d < HD; ++d) acc += kdec[t * RS + d] * "
         "G[d * RS + j];\n"
         "      for (int s = t; s < kL; ++s) acc += A[s * kL + t] * "
         "dys[s * RS + j];", "")],
    "no_A": [("      if (s < t) {\n        for (int d = 0; d < HD; ++d)",
              "      if (s < 0) {\n        for (int d = 0; d < HD; ++d)")],
    "no_drdkdw": [
        ("    for (int i = tid; i < kL * HD; i += kThreads) {\n"
         "      const int t = i / HD, d = i - t * HD;\n      const float lct",
         "    for (int i = tid; i < 0; i += kThreads) {\n"
         "      const int t = i / HD, d = i - t * HD;\n      const float lct")],
    "no_G": [("#pragma unroll\n      for (int t = 0; t < kL; ++t) acc += "
              "rdec[t * RS + d] * dys[t * RS + j];\n", "")],
}


def edited(source: str, edits, name: str, what: str) -> str:
    """``source`` with the variant's edits; raises naming the edit the
    source no longer has."""
    for old, new in edits:
        if old not in source:
            raise RuntimeError(f"{name}: {what} no longer has {old!r}")
        source = source.replace(old, new)
    return source


def build(name: str, text: str, stem: str) -> ctypes.CDLL:
    from repro_torch.kernels import common
    out_dir = common.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / f"{stem}_{name}.cu"
    src.write_text(text)
    lib = out_dir / f"{stem}_{name}.so"
    proc = subprocess.run([common._nvcc(), *common.NVCC_FLAGS, "-o",
                           str(lib), str(src)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    return ctypes.CDLL(str(lib))


def build_all(table, source, what, stem):
    texts = {n: edited(source, e, n, what) for n, e in table.items()}
    with ThreadPoolExecutor(len(texts)) as pool:
        return dict(zip(texts, pool.map(
            lambda n: build(n, texts[n], stem), texts)))


def forward(torch, chip_smoke, heads) -> dict:
    from repro_torch.kernels import common
    libs = build_all(EDITS, (common.CSRC / "wkv.cu").read_text(),
                     "csrc/wkv.cu", "wkv")
    dev = torch.device("cuda")
    res = {}
    for H in heads:
        B, T, hd = 4, 3072, 64
        x = chip_smoke.wkv_inputs(torch, B, T, H, hd, 93, dev)
        y, s_out = torch.empty_like(x[0]), torch.empty_like(x[5])
        stream = torch.cuda.current_stream(dev).cuda_stream
        ms = {}
        for name, lib in libs.items():
            fn = lib.wkv_launch
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 \
                + [ctypes.c_void_p]

            def call(fn=fn, name=name):
                err = fn(*(a.data_ptr() for a in x), y.data_ptr(),
                         s_out.data_ptr(), None, B, T, H, hd, dev.index or 0,
                         stream)
                if err:
                    raise RuntimeError(f"{name}: cudaError {err}")
            ms[name] = chip_smoke.time_ms(torch, call)
        key = f"[{B},{T},{H},{hd}]"
        res[key] = report(key, ms, B * H)
    return res


def backward(torch, chip_smoke, src: Path) -> dict:
    from repro_torch.kernels.rwkv_scan import wkv_cuda
    source = src.read_text()
    table = BWD_EDITS if "mma.sync" in source else BWD_EDITS_FIRST
    libs = build_all(table, source, str(src), "wkv_bwd")
    dev = torch.device("cuda")
    B, T, H, hd = chip_smoke.WKV_BWD_SHAPES[0]
    r, k, v, w, u, s0, dy, ds = chip_smoke.wkv_bwd_inputs(torch, B, T, H,
                                                          hd, 99, dev)
    chunks = wkv_cuda(r, k, v, w, u, s0, save_chunks=True)[2]
    outs = [torch.empty_like(r) for _ in range(4)]
    du_part = r.new_empty((B, H, hd))
    du, ds0 = torch.empty_like(u), torch.empty_like(ds)
    ptrs = [x.data_ptr() for x in (r, k, v, w, u, chunks, dy, ds, *outs,
                                   du_part, du, ds0)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    ms = {}
    for name, lib in libs.items():
        fn = lib.wkv_bwd_launch
        fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]

        def call(fn=fn, name=name):
            err = fn(*ptrs, B, T, H, hd, dev.index or 0, stream)
            if err:
                raise RuntimeError(f"{name}: cudaError {err}")
        ms[name] = chip_smoke.time_ms(torch, call)
    key = f"[{B},{T},{H},{hd}]"
    return {key: report(key, ms, B * H)}


def report(key: str, ms: dict, blocks: int) -> dict:
    cost = {n: ms["full"] - t for n, t in ms.items() if n != "full"}
    print(f"{key} ({blocks} blocks): " + ", ".join(
        f"{n} {t:.4f} ms" for n, t in ms.items()), flush=True)
    return {"blocks": blocks, "ms": ms, "full_less_variant_ms": cost}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--heads", type=int, nargs="+", default=[40, 33])
    ap.add_argument("--bwd", action="store_true",
                    help="ablate K5-bwd (csrc/wkv_bwd.cu) instead of K5")
    ap.add_argument("--src", type=Path, default=ROOT,
                    help="checkout whose wkv_bwd.cu --bwd ablates")
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("wkv_ablation: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    res = {"card": torch.cuda.get_device_name(0), "label": args.label}
    if args.bwd:
        src = args.src / "src/repro_torch/kernels/csrc/wkv_bwd.cu"
        res["source"] = str(src)
        res["shapes"] = backward(torch, chip_smoke, src)
    else:
        res["shapes"] = forward(torch, chip_smoke, args.heads)
    print(chip_smoke.smi())
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
