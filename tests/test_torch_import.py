"""The PyTorch port stands alone: no JAX and nothing of ``repro`` in its
import graph, and no silent CPU fallback when no GPU is asked for."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")

IMPORT_ALL = r"""
import pkgutil, sys
sys.path.insert(0, {src!r}); sys.path.insert(0, {root!r})
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    __import__(m.name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print("MODULES", len([m for m in sys.modules if m.startswith("repro_torch")]))
print("BAD", bad)
print("MISSING", sorted(m for m in {new!r} if m not in sys.modules))
"""

# the sharding context and the dry run (and the quickstart), which must
# import no JAX either
NEW_MODULES = ("repro_torch.sharding", "repro_torch.launch.mesh",
               "repro_torch.launch.shapes", "repro_torch.launch.shardings",
               "repro_torch.launch.dryrun", "repro_torch.quickstart")


def test_port_imports_no_jax_and_no_reference():
    code = IMPORT_ALL.format(src=os.path.join(ROOT, "src"), root=ROOT,
                             new=NEW_MODULES)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines())
    assert int(lines["MODULES"]) >= 30
    assert lines["BAD"] == "[]"
    assert lines["MISSING"] == "[]"


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_device_none_raises_without_gpu(no_gpu):
    from repro_torch.device import resolve_device
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_raise_without_gpu(no_gpu):
    from repro_torch import convert
    from repro_torch.cli import main
    from repro_torch.configs.paper_cnn import CNNConfig
    from repro_torch.core import scheduling as S
    from repro_torch.data import sort_and_partition, synthetic_image_dataset
    from repro_torch.fl import FederatedTrainer, FLConfig
    from repro_torch.models.registry import build_model
    from repro_torch.serve import main as serve_main

    cfg = CNNConfig(name="m", kind="paper_cnn", num_classes=2, image_size=8,
                    dropout=False, width=0.25)
    ds = synthetic_image_dataset(num_classes=2, num_per_class=8,
                                 image_size=8)
    parts = sort_and_partition(ds.labels, 4, 1, np.random.default_rng(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FederatedTrainer(build_model(cfg), ds, ds, parts,
                         FLConfig(num_devices=4))
    prob = S.Problem(p_dev=np.eye(3), global_dist=np.ones(3) / 3,
                     class_weights=np.ones(3), sigma=1.0, batch_size=4,
                     min_bw=np.ones(3), total_bw=2.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        S.solve_many([prob], "gs", backend="torch")
    assert S.solve_many([prob], "gs", backend="numpy")[0].mask.any()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.params_from_jax({"b1": np.zeros(120)}, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--rounds", "1", "--devices", "4"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_main(["--arch", "rwkv6-3b", "--reduced", "--gen", "2"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.lm_params_from_jax({"embed": np.zeros((4, 2))})
    from repro_torch.launch import federated_lm_silos, train
    for entry in (train.main, federated_lm_silos.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry(["--arch", "rwkv6-3b", "--reduced"])
    # the default architecture, qwen2-7b, as the reference's entry points
    for entry in (serve_main, train.main, federated_lm_silos.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry(["--reduced"])


def test_kernel_wrappers_take_cuda_tensors_only():
    """A CPU tensor never reaches a kernel wrapper silently: the wrappers
    raise, and ``ops`` routes it to the plain version instead."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.persample_gradnorm import (
        persample_gradnorm_cuda, persample_gradnorm_cuda_batched)
    from repro_torch.kernels.wemd_swap import wemd_add_cuda, wemd_swap_cuda
    p_dev = torch.rand(2, 5, 3)
    args = (p_dev.sum(1), p_dev, p_dev.mean(1), torch.ones(2, 3),
            torch.full((2,), 2.0))
    for fn in (wemd_add_cuda, wemd_swap_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args)
    h, logits = torch.randn(4, 6), torch.randn(4, 3)
    labels = torch.tensor([0, 1, 2, 0])
    with pytest.raises(ValueError, match="CUDA"):
        persample_gradnorm_cuda(h, logits, labels)
    with pytest.raises(ValueError, match="CUDA"):
        persample_gradnorm_cuda_batched(h[None], logits[None], labels[None])
    torch.testing.assert_close(ops.wemd_swap(*args), ref.wemd_swap_ref(*args))
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="no kernel"):
        ops.wemd_add(*meta)


def test_wemd_dispatch_passes_f32_and_f64_through():
    """On the CUDA route the dispatcher hands contiguous f32 or f64 inputs
    to the kernel as the same tensors (no cast, no copy: the kernel rounds
    f64 on load), makes strided ones contiguous in their dtype, and casts
    mixed or other dtypes to f32."""
    from repro_torch.kernels.ops import _wemd_cuda_args
    p_dev = torch.rand(2, 5, 3, dtype=torch.float64)
    args = [p_dev.sum(1), p_dev, p_dev.mean(1), torch.ones(2, 3,
            dtype=torch.float64), torch.full((2,), 2.0, dtype=torch.float64)]
    for dtype in (torch.float64, torch.float32):
        xs = [a.to(dtype) for a in args]
        assert all(y is x for x, y in zip(xs, _wemd_cuda_args(xs)))
    strided = [args[0], p_dev.transpose(1, 2).contiguous().transpose(1, 2),
               *args[2:]]
    got = _wemd_cuda_args(strided)
    assert all(x.is_contiguous() and x.dtype == torch.float64 for x in got)
    torch.testing.assert_close(got[1], p_dev, atol=0, rtol=0)
    for xs in ([args[0].float()] + args[1:], [a.half() for a in args]):
        got = _wemd_cuda_args(xs)
        assert all(x.dtype == torch.float32 and x.is_contiguous()
                   for x in got)
