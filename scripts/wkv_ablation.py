#!/usr/bin/env python3
"""Where the WKV kernel's time goes, on one NVIDIA GPU, with no profiler
that reads inside a kernel: time ``csrc/wkv.cu`` with one step of its
chunk loop taken out at a time.

    python3 scripts/wkv_ablation.py [--heads 40 33]

Each variant is the kernel's source with one text edit, built by
``nvcc`` with the port's flags into ``.torch_ext_build/ablation/``.  The
edits (``EDITS``) match lines of ``csrc/wkv.cu`` exactly, so they follow
the kernel's text: an edit to one of those lines must be made here too
(the script fails, naming the edit, when the source no longer has it).
A variant computes a wrong result and is only timed:

  full        the kernel as it is;
  no_copies   step 1: no cp.async copies (the barriers stay);
  no_decays   step 2: no log-space decays, decayed rows or A's diagonal;
  no_A        step 3: no pairs of A;
  no_y        step 4, first half: no y from the state entering the chunk;
  no_state    step 5: no state update.

At [4, 3072, H, 64] for each H of ``--heads`` (40 is rwkv6-3b's: 160
blocks on the card's 132 SMs; 33 gives 132 blocks, one an SM),
``chip_smoke.py``'s inputs (seed 93): the median per-call time by CUDA
events (``chip_smoke.time_ms``) of each variant, and the full kernel's
time less the variant's.  Prints the card's name and power
limit, then one JSON object as the last line.
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


def build(name: str, source: str) -> ctypes.CDLL:
    from repro_torch.kernels import common
    text = source
    for old, new in EDITS[name]:
        if old not in text:
            raise RuntimeError(f"{name}: csrc/wkv.cu no longer has {old!r}")
        text = text.replace(old, new)
    out_dir = common.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / f"wkv_{name}.cu"
    src.write_text(text)
    lib = out_dir / f"wkv_{name}.so"
    proc = subprocess.run([common._nvcc(), *common.NVCC_FLAGS, "-o",
                           str(lib), str(src)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    return ctypes.CDLL(str(lib))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--heads", type=int, nargs="+", default=[40, 33])
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("wkv_ablation: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import common
    source = (common.CSRC / "wkv.cu").read_text()
    with ThreadPoolExecutor(len(EDITS)) as pool:
        libs = dict(zip(EDITS, pool.map(lambda n: build(n, source), EDITS)))
    dev = torch.device("cuda")
    res = {"card": torch.cuda.get_device_name(0), "shapes": {}}
    for H in args.heads:
        B, T, hd = 4, 3072, 64
        x = chip_smoke.wkv_inputs(torch, B, T, H, hd, 93, dev)
        y, s_out = torch.empty_like(x[0]), torch.empty_like(x[5])
        stream = torch.cuda.current_stream(dev).cuda_stream
        ms = {}
        for name, lib in libs.items():
            fn = lib.wkv_launch
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 \
                + [ctypes.c_void_p]

            def call(fn=fn):
                err = fn(*(a.data_ptr() for a in x), y.data_ptr(),
                         s_out.data_ptr(), B, T, H, hd, dev.index or 0,
                         stream)
                if err:
                    raise RuntimeError(f"{name}: cudaError {err}")
            ms[name] = chip_smoke.time_ms(torch, call)
        cost = {n: ms["full"] - t for n, t in ms.items() if n != "full"}
        res["shapes"][f"[{B},{T},{H},{hd}]"] = {
            "blocks": B * H, "ms": ms, "full_less_variant_ms": cost}
        print(f"[{B},{T},{H},{hd}] ({B * H} blocks): " + ", ".join(
            f"{n} {t:.4f} ms" for n, t in ms.items()), flush=True)
    print(chip_smoke.smi())
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
