"""The port's dry run (``repro_torch.launch.dryrun``) and its trace
counter (``roofline.TraceCounter``), on the CPU.

Each case runs in a subprocess that starts a ``"fake"`` process group of
8 ranks (4 x 2 mesh; no process group in the pytest worker): every
family's reduced train step traces on meta tensors with the production
sharding rules and counts FLOPs (the counterpart of the reference's
``test_debug_mesh_dryrun_lowers``), and so does every family's decode
step at batch 8 and batch 1 over a cache at the decode rules'
placements; the counter gives exactly N * M *
itemsize bytes for a known all-gather and the reference's collective
keys; and a sharded product's FLOPs are its local ones.
"""
import json
import os
import subprocess
import sys

from repro.roofline.analysis import COLLECTIVE_OPS

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def run_sub(script: str):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c",
                          f"import sys; sys.path.insert(0, {SRC!r})\n"
                          + script], env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-6000:]
    return [json.loads(line[5:]) for line in out.stdout.splitlines()
            if line.startswith("JSON ")]


def test_debug_mesh_dryrun_traces_every_family():
    res = run_sub('''
import json
from repro_torch.configs import get_config, list_archs
from repro_torch.launch.dryrun import fake_group, trace_step
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.shapes import InputShape
fake_group(8)
mesh = make_debug_mesh(4, 2)
for arch in list_archs():
    cfg = get_config(arch).reduced()
    ctx, c, s = trace_step(cfg, InputShape("debug", 64, 8, "train"), mesh)
    print("JSON " + json.dumps({"arch": arch, "flops": c.flops,
                               "bytes": c.bytes, "peak": c.peak,
                               "coll": c.collective_bytes()}))
''')
    assert len(res) == 10
    for r in res:
        assert r["flops"] > 0 and r["bytes"] > 0 and r["peak"] > 0, r
        assert sorted(r["coll"]) == sorted(COLLECTIVE_OPS + ("counts",))
        assert sum(r["coll"]["counts"].values()) > 0, r


def test_debug_mesh_dryrun_traces_every_decode():
    res = run_sub('''
import json
from repro_torch.configs import get_config, list_archs
from repro_torch.launch.dryrun import fake_group, trace_step
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.shapes import InputShape
fake_group(8)
mesh = make_debug_mesh(4, 2)
for arch in list_archs():
    cfg = get_config(arch).reduced()
    for B in (8, 1):
        ctx, c, s = trace_step(cfg, InputShape("debug", 64, B, "decode"),
                               mesh)
        print("JSON " + json.dumps({"arch": arch, "B": B,
                                   "seq": list(ctx.seq_axes),
                                   "flops": c.flops, "bytes": c.bytes,
                                   "coll": c.collective_bytes()}))
''')
    assert len(res) == 20
    for r in res:
        assert r["flops"] > 0 and r["bytes"] > 0, r
        assert sum(r["coll"]["counts"].values()) > 0, r
        # batch 1 splits the cache length over the idle batch axis
        assert ("data" in r["seq"]) == (r["B"] == 1), r
    # reduced recurrentgemma's key heads do not divide the model axis:
    # its cache length is split over "model" too
    assert [r["seq"] for r in res if r["arch"] == "recurrentgemma-2b"] \
        == [["model"], ["data", "model"]]


def test_counter_collective_bytes_and_local_flops():
    res = run_sub('''
import json, torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.launch.dryrun import fake_group
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.roofline import TraceCounter
fake_group(8)
mesh = make_debug_mesh(4, 2)
N, M = 8, 16
x = distribute_tensor(torch.empty(N, M, device="meta"), mesh,
                      [Shard(0), Replicate()])
with TraceCounter() as c:
    x.redistribute(mesh, [Replicate(), Replicate()])
gather = c.collective_bytes()
a = distribute_tensor(torch.empty(8, 64, device="meta"), mesh,
                      [Shard(0), Replicate()])
b = distribute_tensor(torch.empty(64, 32, device="meta"), mesh,
                      [Replicate(), Replicate()])
with TraceCounter() as c:
    a @ b
print("JSON " + json.dumps({"gather": gather, "flops": c.flops}))
''')
    (r,) = res
    assert r["gather"]["all-gather"] == 8 * 16 * 4
    assert r["gather"]["counts"]["all-gather"] == 1
    assert sorted(r["gather"]) == sorted(COLLECTIVE_OPS + ("counts",))
    for k in COLLECTIVE_OPS:
        if k != "all-gather":
            assert r["gather"][k] == 0 and r["gather"]["counts"][k] == 0
    # the local product [2, 64] @ [64, 32] of rank 0, not the global one
    assert r["flops"] == 2 * 2 * 64 * 32
