"""The frozen counts against the program's own arithmetic as it stands:
rwkv6-3b's parameters against ``roofline.count_params``, and K3's, K5's
and K5-bwd's least times against the bound column of ``chip_smoke.py``
at the shapes the cells launch them at."""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench.counts import kernels, resnet18gn, rwkv6  # noqa: E402


def _model(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                      .read_text())["model"]


def test_rwkv6_params_equal_the_ports_count():
    from repro_torch.configs import get_config
    from repro_torch.roofline.analysis import count_params
    assert rwkv6.count_params(_model("rwkv6-3b")) == \
        count_params(get_config("rwkv6-3b"))[0] == 3_098_542_080


def test_resnet18gn_forward_flops_by_layer():
    m = _model("resnet18gn-cifar100")
    layers = resnet18gn.layers(m)
    assert len(layers) == 1 + 16 + 3 + 1          # stem, convs, projs, fc
    assert resnet18gn.forward_flops(m) == 1_110_937_600


@pytest.mark.parametrize("name,fn,shapes", [
    ("persample_gradnorm", kernels.k3, ((23, 32, 512), (23, 32, 100))),
    ("persample_gradnorm", kernels.k3, ((184, 32, 512), (184, 32, 100))),
    ("wkv", kernels.k5, ((16, 1024, 40, 64),)),
    ("wkv", kernels.k5, ((4, 3072, 40, 64),)),
    ("wkv_bwd", kernels.k5_bwd, ((16, 1024, 40, 64),)),
    ("wkv_bwd", kernels.k5_bwd, ((16, 256, 40, 64),)),
])
def test_kernel_bounds_equal_chip_smoke(name, fn, shapes):
    import chip_smoke
    ms, _ = chip_smoke.bound(name, shapes)
    assert fn(shapes)[2] * 1e3 == pytest.approx(ms, rel=1e-12)
    assert kernels.bound_seconds(fn, {shapes: 3}) == pytest.approx(
        3 * ms * 1e-3, rel=1e-12)
